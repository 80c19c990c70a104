"""The AIR STARK prover: multi-column traces, periodic columns, transition
constraints of degree at most 2 and boundary constraints, proved with the
trace LDE, one Merkle tree over full rows, the constraint composition over
blocks of the coset, FRI and the openings.  Constraints are written once
against the algebra of `DevAlg`, vectorised over the LDE coset on int64
tensors.  The composition quotient has degree < 2n, so FRI proves it on the
ext_blowup*n coset at ratio ext_blowup/2."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import numpy as np
import torch

from . import fri, gl, merkle
from . import ntt as nttm
from .transcript import Transcript

# Coset points per block of the composition: the block bounds the (12, 12,
# block) products of the Poseidon matvecs and the field product's temporaries.
COMP_BLOCK = 1 << 19

# ---------------------------------------------------------------------------
# constraint algebra: one constraint definition, two evaluation backends


class DevAlg:
    """Vectorised Goldilocks ops over (a block of) the LDE coset, on int64
    tensors.  A constraint family of arity k is a (k, m) tensor; the scalar
    entry points broadcast."""

    batched = True

    def __init__(self, shape, device):
        self.shape = tuple(shape)
        self.device = device

    def c(self, v: int) -> torch.Tensor:
        return gl.full((), v, self.device)

    def full(self, v: int) -> torch.Tensor:
        """Constant broadcast to the evaluation shape (stackable)."""
        return gl.full(self.shape, v, self.device)

    def add(self, a, b):
        return gl.add(a, b)

    def sub(self, a, b):
        return gl.sub(a, b)

    def mul(self, a, b):
        return gl.mul(a, b)

    def stack(self, parts):
        return torch.stack(list(parts), dim=0)

    def concat0(self, parts):
        return torch.cat([p if p.dim() > 1 else p[None] for p in parts], dim=0)

    def zeros(self, k):
        return gl.zeros((k,) + self.shape, self.device)

    def get0(self, x, i):
        return x[i]

    def slice0(self, x, a, b):
        return x[a:b]

    def sum0(self, x):
        """Field sum over the leading axis, as a tree of halvings (a field
        sum has the same bits in any order)."""
        while x.shape[0] > 1:
            half = x.shape[0] // 2
            s = gl.add(x[:half], x[half : 2 * half])
            x = s if x.shape[0] % 2 == 0 else torch.cat([s, x[2 * half :]], dim=0)
        return x[0]

    def const_matrix(self, rows) -> torch.Tensor:
        """(r, c) matrix (or (r,) vector) of field constants."""
        return gl.from_int(np.asarray(rows, dtype=np.uint64), self.device)

    def scale_rows(self, vec, x):
        """(k,) constant vector x one m-shaped value -> (k, m) family."""
        return gl.mul(vec[:, None], x)

    def matvec(self, mat, x):
        """(r, c) constant matrix x (c, m) values -> (r, m): one broadcast
        product (r, c, m), then the sum over c."""
        prod = gl.mul(mat[:, :, None], x[None, :, :])
        return self.sum0(prod.movedim(1, 0))


@dataclass
class Constraint:
    """fn(alg, cur, nxt, per) -> constraint value(s).

    cur/nxt: indexable views of the trace columns at x and w·x.
    per: indexable view of the periodic columns at x.
    domain: 'transition' vanishes on H \\ {last row}; 'all' on all of H.
    arity: >1 means fn returns a stacked family of constraints (leading
    axis k), each member with its own alpha."""

    name: str
    fn: Callable
    domain: str = "transition"
    arity: int = 1


@dataclass
class Air:
    n: int
    n_cols: int
    periodic: List[np.ndarray]
    constraints: List[Constraint]
    name: str = "air"
    ext_blowup: int = 8  # LDE factor B; composition degree bound = 2n = Bn/4

    def __post_init__(self):
        assert self.n & (self.n - 1) == 0
        for p in self.periodic:
            L = len(p)
            assert L & (L - 1) == 0 and self.n % L == 0, "period must divide n"
        for c in self.constraints:
            if c.domain not in ("transition", "all"):
                raise ValueError(f"unknown constraint domain {c.domain!r}")
        self._cache: dict = {}

    def fri_params(self, num_queries: int = 30, grind_bits: int = 0) -> fri.FriParams:
        # the composition has degree < 2n and is committed on the
        # ext_blowup·n coset, so the honest FRI ratio is ext_blowup/2
        return fri.FriParams(
            blowup=self.ext_blowup // 2,
            num_queries=num_queries,
            terminal_size=64,
            grind_bits=grind_bits,
        )

    # -- circuit-constant caches ---------------------------------------------

    def periodic_lde(self, shift: int, device) -> torch.Tensor:
        """(n_periodic, m) LDE of the tiled periodic patterns on the shift·H_m
        coset, made once per (shift, device)."""
        key = ("per", shift, torch.device(device))
        if key not in self._cache:
            tiled = np.zeros((len(self.periodic), self.n), dtype=np.uint64)
            for k, p in enumerate(self.periodic):
                tiled[k] = np.tile(np.asarray(p, dtype=np.uint64), self.n // len(p))
            self._cache[key] = nttm.lde_columns(gl.from_int(tiled, device), self.ext_blowup, shift)
        return self._cache[key]


@dataclass
class Boundary:
    """col(w^row) == value; value is instance data (public input)."""

    col: int
    row: int
    value: int


# ---------------------------------------------------------------------------
# prover


def _comp_aux(air: Air, shift: int, b_rows: tuple, device):
    """The coset's denominators and factors for the composition, on the
    device, made once per (air, shift, boundary rows, device):
    1/Z_H(x) (period B on the coset), x - w_last, and 1/(x - w^r) for every
    boundary row r (one batch inversion each)."""
    key = ("aux", shift, b_rows, torch.device(device))
    if key in air._cache:
        return air._cache[key]
    n, B = air.n, air.ext_blowup
    m = n * B
    w_m = gl.primitive_root_of_unity(m)
    w_n = gl.primitive_root_of_unity(n)
    x = gl.mul(gl.powers(w_m, m, device), gl.full((), shift, device))
    # Z_H(x) = x^n - 1 on the coset has period B: shift^n·(w_m^n)^j - 1
    wn = gl.h_pow(w_m, n)
    zh_pat = [(gl.h_mul(gl.h_pow(shift, n), gl.h_pow(wn, j)) - 1) % gl.P for j in range(B)]
    zh_inv = gl.from_int([gl.h_inv(z) for z in zh_pat], device).repeat(m // B)
    last_fac = gl.sub(x, gl.full((), gl.h_pow(w_n, n - 1), device))
    b_inv = {
        r: gl.batch_inv(gl.sub(x, gl.full((), gl.h_pow(w_n, r), device))) for r in b_rows
    }
    air._cache[key] = (zh_inv, last_fac, b_inv)
    return air._cache[key]


def _composition(air: Air, lde_cols: torch.Tensor, alphas: List[int], boundaries: List[Boundary],
                 shift: int) -> torch.Tensor:
    """(m,) composition Σ alpha_i·q_i over the LDE coset from the (C, m)
    extended columns, block by block."""
    n, B = air.n, air.ext_blowup
    m = n * B
    dev = lde_cols.device
    b_rows = tuple(sorted({b.row for b in boundaries}))
    zh_inv, last_fac, b_inv = _comp_aux(air, shift, b_rows, dev)
    per = air.periodic_lde(shift, dev)
    alphas_t = gl.from_int(np.asarray(alphas, dtype=np.uint64), dev)
    n_con_alphas = sum(c.arity for c in air.constraints)
    b_cols = [b.col for b in boundaries]
    bvals = gl.from_int(np.asarray([b.value % gl.P for b in boundaries], dtype=np.uint64), dev)

    comp = torch.empty(m, dtype=torch.int64, device=dev)
    for s in range(0, m, COMP_BLOCK):
        e = min(s + COMP_BLOCK, m)
        alg = DevAlg((e - s,), dev)
        cur = lde_cols[:, s:e]
        if e + B <= m:
            nxt = lde_cols[:, s + B : e + B]
        else:  # the next-row view wraps around the coset's end
            nxt = torch.cat([lde_cols[:, s + B :], lde_cols[:, : e + B - m]], dim=1)
        per_blk = per[:, s:e]
        sums = {"transition": None, "all": None}
        off = 0
        for c in air.constraints:
            v = c.fn(alg, cur, nxt, per_blk)  # (block,) or (arity, block)
            if c.arity == 1:
                term = gl.mul(v, alphas_t[off])
            else:
                term = alg.sum0(gl.mul(v, alphas_t[off : off + c.arity, None]))
            sums[c.domain] = term if sums[c.domain] is None else gl.add(sums[c.domain], term)
            off += c.arity
        acc = sums["all"]
        if sums["transition"] is not None:
            t = gl.mul(sums["transition"], last_fac[s:e])
            acc = t if acc is None else gl.add(acc, t)
        out = gl.mul(acc, zh_inv[s:e]) if acc is not None else alg.full(0)
        if boundaries:
            v = gl.sub(lde_cols[b_cols, s:e], bvals[:, None])
            q = gl.mul(v, torch.stack([b_inv[b.row][s:e] for b in boundaries]))
            out = gl.add(out, alg.sum0(gl.mul(q, alphas_t[n_con_alphas:, None])))
        comp[s:e] = out
    return comp


def prove(air: Air, trace_rows: torch.Tensor, publics: List[int], boundaries: List[Boundary],
          num_queries: int = 30, shift: int = gl.MULTIPLICATIVE_GENERATOR) -> dict:
    """An AIR STARK proof for an (n, n_cols) trace, an int64 tensor of
    canonical words; the proof is made on the trace's device.  Raises
    AssertionError when the trace violates a constraint (the composition is
    then not of low degree and FRI's terminal check fires)."""
    n, C = trace_rows.shape
    assert n == air.n and C == air.n_cols
    B = air.ext_blowup
    m = n * B
    dev = trace_rows.device

    lde_cols = nttm.lde_columns(trace_rows.T, B, shift)  # (C, m)
    tree = merkle.commit_tree(lde_cols.T)  # rows (m, C), read through their strides
    root = tree.root()

    transcript = Transcript(f"ezt-air/{air.name}")
    transcript.absorb("public", [len(publics)] + [int(v) % gl.P for v in publics])
    transcript.absorb("boundary", [v for b in boundaries for v in (b.col, b.row, b.value % gl.P)])
    transcript.absorb("trace-root", root)
    n_alphas = sum(c.arity for c in air.constraints) + len(boundaries)
    alphas = transcript.challenges("alpha", n_alphas)

    comp = _composition(air, lde_cols, alphas, boundaries, shift)
    fri_out = fri.fri_prove(comp, shift, transcript, air.fri_params(num_queries))

    all_idx = []
    for jj in fri_out.layer0_indices:
        all_idx += [jj, (jj + B) % m, jj + m // 2, (jj + m // 2 + B) % m]
    idx_t = torch.as_tensor(all_idx, dtype=torch.int64, device=dev)
    row_vals = gl.to_int(lde_cols[:, idx_t].T)  # (4Q, C), one transfer
    all_paths = tree.open_many(all_idx)
    openings = []
    for q in range(len(fri_out.layer0_indices)):
        openings.append([
            {
                "index": int(all_idx[i]),
                "row": [str(int(x)) for x in row_vals[i]],
                "path": [[str(x) for x in p] for p in all_paths[i]],
            }
            for i in range(4 * q, 4 * q + 4)
        ])

    return {
        "version": 1,
        "air": air.name,
        "n": n,
        "n_cols": C,
        "ext_blowup": B,
        "shift": str(shift),
        "num_queries": num_queries,
        "publics": [str(int(v) % gl.P) for v in publics],
        "boundaries": [[b.col, b.row, str(b.value % gl.P)] for b in boundaries],
        "trace_root": [str(x) for x in root],
        "fri": fri_out.proof,
        "trace_openings": openings,
    }
