"""Number-theoretic transform over Goldilocks — port of eigen_zeth_tpu/ops/ntt.py.

Convention (as in the JAX package): ntt(x)[k] = Σ_j x[j]·w^{jk} with w the
primitive n-th root gl.primitive_root_of_unity(n); intt is its exact
inverse (scaled by 1/n).  The transform is unique, so any butterfly
schedule gives the same bits.  This one is the plain iterative radix-2 DIT:
one bit-reversal gather, then log2(n) vectorized butterfly stages along the
last axis.  Twiddles come from the host (numpy) once per (n, direction,
device).

The four-step decomposition n = R·C (`ntt_four_step`: size-R transforms
along axis 0, a twiddle product, size-C transforms along axis 1, a
transpose) is the JAX package's: `ntt_auto` takes it from 2^14 up, and the
domain-sharded NTT (parallel/ntt_dist.py) splits the same plan over shards.

`lde_columns` is the AIR prover's transform: INTT and coset LDE of a wide
(columns, n) matrix a few columns at a time, because a butterfly stage and
the field product inside it hold about ten temporaries of their operand's
size, and the extended matrix of a production attestation alone is 3.6 GB.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import goldilocks as gl

_PLANS: dict = {}


def _bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def make_plan(n: int, inverse: bool, device):
    """(bit-reversal index, per-stage twiddles, 1/n or None) on `device`."""
    key = (n, inverse, torch.device(device))
    if key not in _PLANS:
        assert n & (n - 1) == 0 and n >= 2, "size must be a power of two"
        w = gl.primitive_root_of_unity(n)
        if inverse:
            w = gl.h_inv(w)
        tw = []
        for s in range(n.bit_length() - 1):
            wm = gl.h_pow(w, n >> (s + 1))
            tw.append(gl.from_int(gl.powers_np(wm, 1 << s), device))
        rev = torch.from_numpy(_bit_reverse_indices(n)).to(device)
        scale = gl.full((), gl.h_inv(n), device) if inverse else None
        _PLANS[key] = (rev, tuple(tw), scale)
    return _PLANS[key]


def _butterflies(x: torch.Tensor, tw) -> torch.Tensor:
    """All DIT stages along the last axis of bit-reversed input."""
    batch = x.shape[:-1]
    n = x.shape[-1]
    for s, w in enumerate(tw):
        half = 1 << s
        v = x.reshape(batch + (n // (2 * half), 2, half))
        lo, hi = v[..., 0, :], v[..., 1, :]
        t = gl.mul(hi, w)
        x = torch.stack([gl.add(lo, t), gl.sub(lo, t)], dim=-2).reshape(batch + (n,))
    return x


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT along the last axis (natural order in and out)."""
    n = x.shape[-1]
    if n == 1:
        return x
    rev, tw, _ = make_plan(n, False, x.device)
    return _butterflies(x.index_select(-1, rev), tw)


def intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT along the last axis."""
    n = x.shape[-1]
    if n == 1:
        return x
    rev, tw, scale = make_plan(n, True, x.device)
    return gl.mul(_butterflies(x.index_select(-1, rev), tw), scale)


def raw(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Bit reversal and butterflies along the last axis, without the
    inverse's 1/n (a four-step plan scales once, at the end)."""
    rev, tw, _ = make_plan(x.shape[-1], inverse, x.device)
    return _butterflies(x.index_select(-1, rev), tw)


# ---------------------------------------------------------------------------
# four-step decomposition


@dataclass(frozen=True)
class FourStepPlan:
    n: int
    rows: int  # R: the transforms along axis 0
    cols: int  # C: the transforms along axis 1
    inverse: bool
    twiddle: torch.Tensor  # (R, C): w^{k1·j2}
    scale: torch.Tensor | None  # 1/n (inverse only)


_FOUR_STEP_PLANS: dict = {}


def make_four_step_plan(n: int, rows: int, inverse: bool, device) -> FourStepPlan:
    """The plan of n = rows·cols on `device` (made once per key)."""
    key = (n, rows, inverse, torch.device(device))
    if key not in _FOUR_STEP_PLANS:
        cols = n // rows
        assert rows * cols == n and rows & (rows - 1) == 0 and cols & (cols - 1) == 0
        w = gl.primitive_root_of_unity(n)
        if inverse:
            w = gl.h_inv(w)
        # every exponent k1·j2 is below R·C = n: one powers ladder and a gather
        pw = gl.powers_np(w, n)
        idx = np.outer(np.arange(rows, dtype=np.int64), np.arange(cols, dtype=np.int64))
        scale = gl.full((), gl.h_inv(n), device) if inverse else None
        _FOUR_STEP_PLANS[key] = FourStepPlan(n, rows, cols, inverse,
                                             gl.from_int(pw[idx], device), scale)
    return _FOUR_STEP_PLANS[key]


def ntt_four_step(x: torch.Tensor, plan: FourStepPlan) -> torch.Tensor:
    """Four-step NTT along the last axis, natural order in and out; the
    inverse when the plan is.  With x viewed as (R, C) row-major
    [j = j1·C + j2]:
      1. size-R NTTs along axis 0
      2. the twiddle w^{k1·j2}
      3. size-C NTTs along axis 1
      4. transpose: X[k1 + k2·R] = Y[k1, k2]"""
    R, C = plan.rows, plan.cols
    batch = x.shape[:-1]
    v = x.reshape(batch + (R, C)).transpose(-1, -2)
    v = raw(v, plan.inverse).transpose(-1, -2)
    v = raw(gl.mul(v, plan.twiddle), plan.inverse)
    out = v.transpose(-1, -2).reshape(x.shape)
    return out if plan.scale is None else gl.mul(out, plan.scale)


def intt_four_step(x: torch.Tensor, plan: FourStepPlan) -> torch.Tensor:
    assert plan.inverse
    return ntt_four_step(x, plan)


# above this size `ntt_auto` takes the four-step plan, as in the JAX package
FOUR_STEP_MIN = 1 << 14


def _four_step_rows(n: int) -> int:
    return 1 << ((n - 1).bit_length() // 2)


def ntt_auto(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Size-adaptive NTT along the last axis: radix-2 below FOUR_STEP_MIN,
    four-step from there.  The same values either way."""
    n = x.shape[-1]
    if n >= FOUR_STEP_MIN:
        return ntt_four_step(x, make_four_step_plan(n, _four_step_rows(n), inverse, x.device))
    return intt(x) if inverse else ntt(x)


def intt_auto(x: torch.Tensor) -> torch.Tensor:
    return ntt_auto(x, inverse=True)


def coset_shift(x: torch.Tensor, shift: int, inverse: bool = False) -> torch.Tensor:
    """Multiply coefficient j by shift^j (evaluate on the coset shift·H)."""
    n = x.shape[-1]
    s = gl.h_inv(shift) if inverse else shift % gl.P
    return gl.mul(x, gl.powers(s, n, x.device))


def lde(coeffs: torch.Tensor, blowup: int, shift: int = gl.MULTIPLICATIVE_GENERATOR) -> torch.Tensor:
    """Low-degree extension: evaluate a degree-<n polynomial on the coset
    shift·H of the blowup·n domain (zero-pad coefficients, coset NTT)."""
    n = coeffs.shape[-1]
    padded = torch.nn.functional.pad(coset_shift(coeffs, shift), (0, n * (blowup - 1)))
    return ntt(padded)


def poly_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Polynomial product via NTT along the last axis, both operands padded
    to the power of two at or above the sum of their lengths (the JAX
    package's size; the top coefficients come out zero)."""
    n = a.shape[-1] + b.shape[-1]
    m = 1 << (n - 1).bit_length()
    fa = ntt(torch.nn.functional.pad(a, (0, m - a.shape[-1])))
    fb = ntt(torch.nn.functional.pad(b, (0, m - b.shape[-1])))
    return intt(gl.mul(fa, fb))


# elements per block of `lde_columns`' output: 2^25 words are 256 MB, so a
# stage's temporaries stay within a few GB whatever the matrix's width
LDE_BLOCK_WORDS = 1 << 25


def lde_columns(cols: torch.Tensor, blowup: int, shift: int = gl.MULTIPLICATIVE_GENERATOR,
                block_cols: int | None = None) -> torch.Tensor:
    """lde(intt(cols), blowup, shift) of a (C, n) matrix of column
    evaluations, `block_cols` columns at a time, into one (C, n·blowup)
    tensor.  The same values as the unblocked call."""
    C, n = cols.shape
    m = n * blowup
    if block_cols is None:
        block_cols = max(1, LDE_BLOCK_WORDS // m)
    out = torch.empty((C, m), dtype=cols.dtype, device=cols.device)
    for s in range(0, C, block_cols):
        out[s : s + block_cols] = lde(intt(cols[s : s + block_cols]), blowup, shift)
    return out
