"""Goldilocks prime field GF(p), p = 2^64 - 2^32 + 1, on int64 tensors.

Port of eigen_zeth_tpu/ops/goldilocks.py.  The JAX package holds an array
of elements as two uint32 planes (lo, hi); here one int64 tensor holds each
canonical value's uint64 bit pattern (values >= 2^63 read as negative).

PyTorch has no unsigned 64-bit arithmetic on every device, so:
  * add/sub/mul wrap modulo 2^64 in int64, and an unsigned compare flips
    the sign bit of both sides (`_ult`);
  * `>>` is arithmetic on int64, so a logical shift masks after shifting;
  * the 128-bit product is built from 32-bit halves and reduced with
    2^64 ≡ 2^32 - 1 and 2^96 ≡ -1 (mod p), exactly as `np_mulmod`.
Values stay canonical (< p) after every op.

The host helpers (`h_*`, `np_*`, `powers_np`, `primitive_root_of_unity`)
are copies of the JAX package's numpy/int code.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling

P = 0xFFFFFFFF00000001  # 2^64 - 2^32 + 1
TWO_ADICITY = 32
MULTIPLICATIVE_GENERATOR = 7

M32 = 0xFFFFFFFF
_MIN = -(1 << 63)


def as_i64(v: int) -> int:
    """Canonical python int -> the int64 value with the same bit pattern."""
    v %= P
    return v - (1 << 64) if v >= 1 << 63 else v


_P_I64 = P - (1 << 64)  # p's bit pattern as int64
_P_FLIP = _P_I64 ^ _MIN


# ---------------------------------------------------------------------------
# host <-> device conversion


def from_int(values, device) -> torch.Tensor:
    """Python ints / numpy uint64 -> int64 tensor of canonical values."""
    arr = np.asarray(values, dtype=np.uint64) % np.uint64(P)
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int64)).to(device)


def to_int(x: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 (host); the prover's reads of the card
    go through here, each a "device.read" span."""
    with profiling.device_read(x):
        return np.ascontiguousarray(x.detach().cpu().numpy()).view(np.uint64)


def full(shape, value: int, device) -> torch.Tensor:
    return torch.full(tuple(shape), as_i64(value), dtype=torch.int64, device=device)


def zeros(shape, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=torch.int64, device=device)


def ones(shape, device) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# core arithmetic


def _ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b on uint64 bit patterns held in int64."""
    return (a ^ _MIN) < (b ^ _MIN)


def _canonical(x: torch.Tensor) -> torch.Tensor:
    """x - p where x >= p (unsigned); input below 2p (mod 2^64)."""
    return torch.where((x ^ _MIN) >= _P_FLIP, x - _P_I64, x)


def add(a, b):
    s = a + b
    # a carry out of bit 63 stands for 2^64 ≡ 2^32 - 1; it cannot carry again
    s = torch.where(_ult(s, a), s + M32, s)
    return _canonical(s)


def sub(a, b):
    d = a - b
    return torch.where(_ult(a, b), d + _P_I64, d)


def neg(a):
    return torch.where(a == 0, a, _P_I64 - a)


def _srl32(x):
    return (x >> 32) & M32


def mul(a, b):
    """(a·b) mod p; the same 32-bit-limb schoolbook and fold as np_mulmod."""
    al, ah = a & M32, _srl32(a)
    bl, bh = b & M32, _srl32(b)
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    mid = lh + hl
    c1 = _ult(mid, lh).to(torch.int64)
    lo = ll + ((mid & M32) << 32)
    c2 = _ult(lo, ll).to(torch.int64)
    hi = hh + _srl32(mid) + (c1 << 32) + c2
    # t = hi·2^64 + lo ≡ lo + hi_lo·(2^32 - 1) - hi_hi  (mod p)
    hi_l, hi_h = hi & M32, _srl32(hi)
    t0 = lo - hi_h
    t0 = torch.where(_ult(lo, hi_h), t0 - M32, t0)
    t1 = hi_l * M32
    res = t0 + t1
    res = torch.where(_ult(res, t0), res + M32, res)
    return _canonical(res)


def square(a):
    return mul(a, a)


def pow_const(a, e: int):
    """a^e for a host-known exponent (square and multiply)."""
    if e == 0:
        return torch.ones_like(a)
    e %= P - 1
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result if result is not None else torch.ones_like(a)


def inv(a):
    """Multiplicative inverse via a^(p-2); inv(0) = 0."""
    return pow_const(a, P - 2)


def scan(op, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan of an associative field op along the last axis
    (Hillis-Steele: log2(n) full-width steps)."""
    if reverse:
        x = torch.flip(x, dims=(-1,))
    n = x.shape[-1]
    s = 1
    while s < n:
        x = torch.cat([x[..., :s], op(x[..., s:], x[..., :-s])], dim=-1)
        s *= 2
    return torch.flip(x, dims=(-1,)) if reverse else x


def batch_inv(a):
    """Montgomery batch inversion along the last axis: one field
    exponentiation plus prefix/suffix product scans.  All inputs nonzero."""
    prefix = scan(mul, a)
    suffix = scan(mul, a, reverse=True)
    total_inv = inv(prefix[..., -1:])
    one = torch.ones_like(a[..., :1])
    excl = mul(
        torch.cat([one, prefix[..., :-1]], dim=-1),
        torch.cat([suffix[..., 1:], one], dim=-1),
    )
    return mul(excl, total_inv)


def powers(base: int, n: int, device) -> torch.Tensor:
    """[base^0, …, base^(n-1)] on the device: a doubling ladder (block
    [2^k, 2^{k+1}) = block [0, 2^k)·base^(2^k)), log2(n) vector muls."""
    base %= P
    if n <= 0:
        return zeros((0,), device)
    out = ones((1,), device)
    step = base
    while out.shape[0] < n:
        blk = min(out.shape[0], n - out.shape[0])
        out = torch.cat([out, mul(out[:blk], full((blk,), step, device))])
        step = h_mul(step, step)
    return out


def select(pred, a, b):
    """Elementwise pred ? a : b."""
    return torch.where(pred, a, b)


# ---------------------------------------------------------------------------
# host-side scalar math (python ints)


def h_mul(a: int, b: int) -> int:
    return (a * b) % P


def h_pow(a: int, e: int) -> int:
    return pow(a, e, P)


def h_inv(a: int) -> int:
    return pow(a, P - 2, P)


def primitive_root_of_unity(order: int) -> int:
    """Primitive `order`-th root of unity; order must divide 2^32."""
    assert order & (order - 1) == 0 and order <= (1 << TWO_ADICITY)
    g = pow(MULTIPLICATIVE_GENERATOR, (P - 1) // (1 << TWO_ADICITY), P)
    return pow(g, (1 << TWO_ADICITY) // order, P)


# --- vectorized numpy field math (host constants, verifier, tests) ---------

_M32 = np.uint64(0xFFFFFFFF)
_U32 = np.uint64(32)


def _over_ignore():
    return np.errstate(over="ignore")


def np_mulmod(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise (a·b) mod P on uint64 numpy arrays."""
    with _over_ignore():
        a = np.asarray(a, dtype=np.uint64)
        b = np.asarray(b, dtype=np.uint64)
        al, ah = a & _M32, a >> _U32
        bl, bh = b & _M32, b >> _U32
        ll = al * bl
        lh = al * bh
        hl = ah * bl
        hh = ah * bh
        mid = lh + hl
        c1 = (mid < lh).astype(np.uint64)
        mid_l = (mid & _M32) << _U32
        lo = ll + mid_l
        c2 = (lo < ll).astype(np.uint64)
        hi = hh + (mid >> _U32) + (c1 << _U32) + c2
        hi_l, hi_h = hi & _M32, hi >> _U32
        t0 = lo - hi_h
        t0 = np.where(lo < hi_h, t0 - _M32, t0)
        t1 = hi_l * _M32
        res = t0 + t1
        res = np.where(res < t0, res + _M32, res)
        return np.where(res >= np.uint64(P), res - np.uint64(P), res)


def powers_np(base: int, n: int) -> np.ndarray:
    """[base^0, …, base^(n-1)] mod P as numpy uint64 (doubling ladder)."""
    base %= P
    out = np.empty(max(n, 1), dtype=np.uint64)
    out[0] = 1
    step = base
    size = 1
    while size < n:
        blk = min(size, n - size)
        out[size : size + blk] = np_mulmod(out[:blk], np.uint64(step))
        step = h_mul(step, step)
        size += blk
    return out[:n]


def np_addmod(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    with _over_ignore():
        a = np.asarray(a, dtype=np.uint64)
        b = np.asarray(b, dtype=np.uint64)
        s = a + b
        wrap = s < a
        s = np.where(wrap, s + _M32, s)
        return np.where(s >= np.uint64(P), s - np.uint64(P), s)


def np_submod(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    with _over_ignore():
        a = np.asarray(a, dtype=np.uint64)
        b = np.asarray(b, dtype=np.uint64)
        d = a - b
        return np.where(a < b, d + np.uint64(P), d)


def np_ntt(values: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Host radix-2 NTT over numpy uint64 (the verifier's host transform)."""
    a = np.asarray(values, dtype=np.uint64).copy()
    n = len(a)
    assert n & (n - 1) == 0
    if n == 1:
        return a
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    bits = n.bit_length() - 1
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    a = a[rev]
    size = 2
    while size <= n:
        w = primitive_root_of_unity(size)
        if inverse:
            w = h_inv(w)
        ws = powers_np(w, size // 2)
        blk = a.reshape(n // size, size)
        lo, hi = blk[:, : size // 2], blk[:, size // 2 :]
        t = np_mulmod(hi, ws[None, :])
        a = np.concatenate([np_addmod(lo, t), np_submod(lo, t)], axis=1).reshape(n)
        size *= 2
    if inverse:
        a = np_mulmod(a, np.uint64(h_inv(n)))
    return a


def np_intt(values: np.ndarray) -> np.ndarray:
    return np_ntt(values, inverse=True)
