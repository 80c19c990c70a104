"""The NTT over Goldilocks and the low-degree extensions: ntt(x)[k] =
sum_j x[j]*w^(jk) with w the primitive n-th root, intt its exact inverse
(scaled by 1/n), by the plain iterative radix-2 DIT on int64 tensors.
`lde_columns` extends a wide (columns, n) matrix a few columns at a time."""

from __future__ import annotations

import numpy as np
import torch

from . import gl

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
