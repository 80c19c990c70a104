"""Multi-precision Montgomery arithmetic on 16-bit limbs (BN254 Fq / Fr).

Port of eigen_zeth_tpu/ops/bigint.py.  The value layout is the JAX
package's: a batch of field elements is a limb-major (16, ...) tensor of
16-bit limbs, stored here as int32, in Montgomery form with R = 2^256.

Plain PyTorch carries the limb arithmetic (add, sub, neg, compares); every
Montgomery multiply goes through `kernels.mont_mul` and every power
(Fermat inversion) through `kernels.mont_pow`, which launch the hand-written
CUDA kernels for a CUDA tensor at every batch size and take the plain
versions only for a CPU tensor.

Carry chains are resolved without a 16-step loop: after one local pass
every limb is in [0, 2^16] (or [-1, 2^16) for borrows), and the remaining
ripple is the carry chain of a 16-bit binary addition, which one integer
add computes for all limbs at once (`_resolve_carries`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

LIMB_BITS = 16
L = 16
MASK = 0xFFFF
_SHIFTS = torch.arange(L, dtype=torch.int64)


def limbs_from_int(value: int, n_limbs: int = L) -> np.ndarray:
    out = np.zeros(n_limbs, dtype=np.int32)
    for i in range(n_limbs):
        out[i] = (value >> (LIMB_BITS * i)) & MASK
    return out


def _col(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """(L,) constant -> (L, 1, ..., 1) broadcasting against ndim-d limbs."""
    return t.reshape((L,) + (1,) * (ndim - 1))


def _resolve_carries(y: torch.Tensor, borrow: bool):
    """Finish a carry (or borrow) ripple over the limb axis.

    y: (L, ...) limbs in [0, 2^16] (carries) or [-1, 2^16) (borrows).  A limb
    generates when it is 2^16 (or -1) and propagates when it is 2^16 - 1
    (or 0).  With A = Σ (g|p)·2^i and B = Σ g·2^i, bit i of (A+B)^A^B is
    the carry into limb i — the carry chain of one binary addition.
    Returns (limbs in [0, 2^16), carry out of the top limb: 0/1)."""
    shifts = _col(_SHIFTS.to(y.device), y.ndim)
    gen = (y == -1) if borrow else (y == 1 << 16)
    prop = (y == 0) if borrow else (y == MASK)
    gw = (gen.to(torch.int64) << shifts).sum(0)
    aw = ((gen | prop).to(torch.int64) << shifts).sum(0)
    s = aw + gw
    cin = (((s ^ aw ^ gw)[None] >> shifts) & 1).to(y.dtype)
    out = ((y - cin) if borrow else (y + cin)) & MASK
    return out, ((s >> L) & 1).to(y.dtype)


def _normalize(x: torch.Tensor, passes: int, borrow: bool = False):
    """Exact carry propagation of limbs x_i (any sign) into 16-bit limbs.

    `passes` local passes (lo + carry-in from the limb below) shrink every
    limb to [0, 2^16] / [-1, 2^16); the bound decides how many are needed.
    Returns (limbs, carry out of the top limb)."""
    top = torch.zeros_like(x[0])
    for _ in range(passes):
        hi = x >> LIMB_BITS  # arithmetic: floor division, sign kept
        x = x & MASK
        x = torch.cat([x[:1], x[1:] + hi[:-1]], dim=0)
        top = top + hi[-1]
    out, c = _resolve_carries(x, borrow)
    return out, top + (-c if borrow else c)


def _bshape(a: torch.Tensor, b: torch.Tensor):
    return a.shape if a.shape == b.shape else torch.broadcast_shapes(a.shape, b.shape)


class MontCtx:
    """Montgomery context for an odd modulus below 2^256.

    Holds the modulus limbs per device (the constants the plain ops
    broadcast) and n0 at the widths of the plain version (16 bits) and of
    the CUDA kernels (32 bits)."""

    def __init__(self, modulus: int):
        assert modulus % 2 == 1 and modulus < 1 << (LIMB_BITS * L)
        self.q = modulus
        self.L = L
        self.R = 1 << (LIMB_BITS * L)
        self.R_mod = self.R % modulus
        self.R2_mod = (self.R * self.R) % modulus
        self.nprime = (-pow(modulus, -1, self.R)) % self.R
        self.n0_16 = self.nprime & MASK
        self.n0_32 = self.nprime & 0xFFFFFFFF
        self.q_limbs_np = limbs_from_int(modulus)
        self._dev: dict = {}

    def q_limbs(self, device) -> torch.Tensor:
        """The modulus as an int64 (L,) tensor on `device` (cached)."""
        key = torch.device(device)
        if key not in self._dev:
            self._dev[key] = torch.from_numpy(self.q_limbs_np.astype(np.int64)).to(key)
        return self._dev[key]

    # -- host <-> device ----------------------------------------------------

    def from_int(self, values, device, mont: bool = True) -> torch.Tensor:
        """Python ints -> (L, ...) int32 limbs on `device` (Montgomery form)."""
        arr = np.asarray(values, dtype=object)
        flat = arr.reshape(-1)
        q, r_mod = self.q, self.R_mod
        if mont:
            ints = [int(v) % q * r_mod % q for v in flat]
        else:
            ints = [int(v) % q for v in flat]
        buf = b"".join(v.to_bytes(2 * L, "little") for v in ints)
        limbs = np.frombuffer(buf, dtype="<u2").reshape(len(ints), L).T
        limbs = np.ascontiguousarray(limbs, dtype=np.int32).reshape((L,) + arr.shape)
        return torch.from_numpy(limbs).to(device)

    def to_int(self, x: torch.Tensor, mont: bool = True) -> np.ndarray:
        """(L, ...) limbs -> object ndarray of python ints."""
        host = x.detach().cpu().numpy()
        flat = host.reshape(L, -1).T.astype("<u2")
        buf = flat.tobytes()
        nbytes = 2 * L
        r_inv = pow(self.R_mod, self.q - 2, self.q) if mont else 1
        out = np.empty(flat.shape[0], dtype=object)
        for i in range(flat.shape[0]):
            v = int.from_bytes(buf[i * nbytes : (i + 1) * nbytes], "little")
            out[i] = (v * r_inv) % self.q if mont else v
        return out.reshape(host.shape[1:])

    def const_mont(self, value: int, shape, device) -> torch.Tensor:
        v = (int(value) % self.q) * self.R_mod % self.q
        base = torch.from_numpy(limbs_from_int(v)).to(device)
        return base.reshape((L,) + (1,) * len(tuple(shape))).expand((L,) + tuple(shape)).clone()

    def one_mont(self, shape, device) -> torch.Tensor:
        return self.const_mont(1, shape, device)

    # -- limb ops (plain PyTorch; all shapes (L, ...)) ------------------------

    def _cond_sub_q(self, t: torch.Tensor, extra: torch.Tensor) -> torch.Tensor:
        """t + extra·2^256 minus q when that is >= 0 (t < 2q)."""
        d = t - _col(self.q_limbs(t.device), t.ndim).to(t.dtype)
        d, borrow = _normalize(d, passes=1, borrow=True)
        ge = (borrow == 0) | (extra > 0)
        return torch.where(ge, d, t)

    def add(self, a, b):
        s, carry = _normalize(a + b, passes=1)
        return self._cond_sub_q(s, carry)

    def sub(self, a, b):
        d, borrow = _normalize(a - b, passes=1, borrow=True)
        wrapped, _ = _normalize(d + _col(self.q_limbs(d.device), d.ndim).to(d.dtype), passes=1)
        return torch.where(borrow < 0, wrapped, d)

    def neg(self, a):
        qb = _col(self.q_limbs(a.device), a.ndim).to(a.dtype).expand_as(a)
        r, _ = _normalize(qb - a, passes=1, borrow=True)
        return torch.where(self.is_zero(a), a, r)

    def is_zero(self, a) -> torch.Tensor:
        return (a == 0).all(dim=0)

    # -- Montgomery product ---------------------------------------------------

    def mont_mul(self, a, b):
        """a·b·R^{-1} mod q: kernel A for CUDA tensors, the plain version on
        the CPU (kernels.mont_mul decides by device)."""
        from . import kernels

        if a.shape == b.shape and a.dim() == 2 and a.is_contiguous() and b.is_contiguous():
            return kernels.mont_mul(self, a, b)  # already the kernel's (16, n) operands
        shape = _bshape(a, b)
        a2 = a.expand(shape).reshape(L, -1).contiguous()
        b2 = b.expand(shape).reshape(L, -1).contiguous()
        return kernels.mont_mul(self, a2, b2).reshape(shape)

    def mont_mul_plain(self, a, b):
        from . import kernels

        shape = _bshape(a, b)
        a2 = a.expand(shape).reshape(L, -1).contiguous()
        b2 = b.expand(shape).reshape(L, -1).contiguous()
        return kernels.mont_mul_plain(self, a2, b2).reshape(shape)

    def mont_sq(self, a):
        return self.mont_mul(a, a)

    def mont_pow(self, a, exponent: int):
        """a^e (Montgomery in/out) for a host-known exponent: one launch of
        the power kernel for CUDA tensors, square and multiply over the
        plain product on the CPU (kernels.mont_pow decides by device)."""
        from . import kernels

        return kernels.mont_pow(self, a.reshape(L, -1).contiguous(), exponent).reshape(a.shape)

    def inv(self, a):
        """a^{-1} via Fermat; inv(0) = 0."""
        return self.mont_pow(a, self.q - 2)


@functools.lru_cache(maxsize=8)
def mont_ctx(modulus: int) -> MontCtx:
    return MontCtx(modulus)
