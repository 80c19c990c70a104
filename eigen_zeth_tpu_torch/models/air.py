"""General AIR framework — port of eigen_zeth_tpu/models/air.py.

Multi-column traces, periodic columns, transition constraints of degree
at most 2 and boundary constraints, proven with the trace-LDE ->
constraint-composition -> FRI pipeline.  The recursive verifier AIR
(models/recursion.py) is built on it.

  * the trace is a dense (n_rows, n_cols) Goldilocks matrix on the device;
    its columns are interpolated and extended a few at a time
    (`ntt.lde_columns`) into one (n_cols, B·n) matrix, which is committed as
    one Merkle tree over full rows without being transposed;
  * constraints are written once against a small algebra interface and
    evaluated twice: vectorised over the LDE coset on the device (`DevAlg`,
    the prover) and on host numpy at the query points (`HostAlg`, the
    verifier);
  * periodic columns (selectors, round constants) are circuit constants:
    the prover extends the tiled pattern once per AIR and device; the
    verifier evaluates the pattern's interpolant at x^(n/L);
  * every constraint has degree <= 2 in trace columns, so the composition
    quotient has degree < 2n and FRI proves it on the 8n-point coset at
    ratio 4.

The composition is pointwise in the coset index apart from the next-row
view (a roll by B points), so it runs over blocks of the coset: a block of
`COMP_BLOCK` points bounds the (12, 12, block) products of the Poseidon
matvecs and the field product's temporaries whatever the trace's size.  The transition constraints share their factor (x - w_last)
and all constraints the inverse vanishing polynomial, so each block takes
Σ alpha_i·v_i first and multiplies once: the field is exact, the proof
bytes are those of multiplying every quotient by itself.

The proofs equal the JAX package's byte for byte.  Its numpy prover mode
and the split of the composition into small compiled groups answer XLA's
compile time and are not carried over.  Verification is host math (numpy
and python ints) and needs no device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import ntt as nttm
from ..utils.profiling import span
from . import fri, merkle
from .transcript import Transcript

# Coset points per block of the composition.  On an H100 the verifier AIR's
# composition over a 2^21 coset is bound by the host's launches up to 2^19
# points a block and by the card from there on (4.6 s at 2^17, 3.0 s at 2^18,
# 1.7 s at 2^19 and at 2^20; scripts/attestation_stages.py), and a block of
# 2^19 points brings the attestation's peak device memory to 16 GB (11 GB at
# 2^18, 27 GB at 2^20).
COMP_BLOCK = 1 << 19

# Called with a stage's name when `prove` has finished it (trace LDE, Merkle
# commit, composition, FRI, openings), at the end of the stage's span; a
# caller that times the stages sets it and synchronises the device inside.
STAGE_HOOK: Callable[[str], None] | None = None


def stage(name: str) -> None:
    if STAGE_HOOK is not None:
        STAGE_HOOK(name)


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


class HostAlg:
    """The same algebra on host numpy uint64 (the verifier): every value is
    a canonical np.uint64 scalar or array, so a family evaluates at a query
    point as it does on the coset."""

    batched = False

    def c(self, v: int):
        return np.uint64(v % gl.P)

    def full(self, v: int):
        return np.uint64(v % gl.P)

    def add(self, a, b):
        return gl.np_addmod(a, b)

    def sub(self, a, b):
        return gl.np_submod(a, b)

    def mul(self, a, b):
        return gl.np_mulmod(a, b)

    def stack(self, parts):
        return np.stack([np.asarray(p, dtype=np.uint64) for p in parts])

    def concat0(self, parts):
        return np.concatenate([np.atleast_1d(np.asarray(p, dtype=np.uint64)) for p in parts])

    def zeros(self, k):
        return np.zeros((k,), dtype=np.uint64)

    def get0(self, x, i):
        return x[i]

    def slice0(self, x, a, b):
        return x[a:b]

    def sum0(self, x):
        acc = np.zeros_like(x[0])
        for i in range(x.shape[0]):
            acc = gl.np_addmod(acc, x[i])
        return acc

    def const_matrix(self, rows):
        return np.asarray(rows, dtype=np.uint64)

    def scale_rows(self, vec, x):
        return gl.np_mulmod(vec, x)

    def matvec(self, mat, x):
        return np.stack([self.sum0(gl.np_mulmod(mat[i], x)) for i in range(mat.shape[0])])


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
        self._per_interp_cache = None

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

    def periodic_interps(self) -> List[np.ndarray]:
        """Host coefficient vectors of each pattern over its period subgroup
        (the value of column k at x is interp_k evaluated at x^(n/L_k))."""
        if self._per_interp_cache is None:
            self._per_interp_cache = [
                gl.np_intt(np.asarray(p, dtype=np.uint64)) for p in self.periodic
            ]
        return self._per_interp_cache

    def periodic_at(self, x: int) -> List[int]:
        """Evaluate every periodic column at one point (host)."""
        out = []
        for p, coeffs in zip(self.periodic, self.periodic_interps()):
            z = gl.h_pow(x, self.n // len(p))
            acc = 0
            for c in reversed([int(v) for v in coeffs]):
                acc = (acc * z + c) % gl.P
            out.append(acc)
        return out

    def periodic_at_many(self, xs: Sequence[int]) -> np.ndarray:
        """(n_periodic, len(xs)) evaluations by a vectorised Horner, the
        columns grouped by period so that each group shares its z powers."""
        interps = self.periodic_interps()
        xs = list(xs)
        out = np.zeros((len(self.periodic), len(xs)), dtype=np.uint64)
        by_len: dict = {}
        for k, p in enumerate(self.periodic):
            by_len.setdefault(len(p), []).append(k)
        for L, ks in by_len.items():
            zs = np.array([gl.h_pow(x, self.n // L) for x in xs], dtype=np.uint64)
            coeffs = np.stack([interps[k] for k in ks])  # (K, L)
            acc = np.zeros((len(ks), len(xs)), dtype=np.uint64)
            for i in range(L - 1, -1, -1):
                acc = gl.np_mulmod(acc, zs[None, :])
                acc = gl.np_addmod(acc, coeffs[:, i : i + 1])
            out[ks, :] = acc
        return out


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

    with span("air.lde"):
        lde_cols = nttm.lde_columns(trace_rows.T, B, shift)  # (C, m)
        stage("lde")
    with span("air.merkle"):
        tree = merkle.commit_tree(lde_cols.T)  # rows (m, C), read through their strides
        root = tree.root()
        stage("merkle")

    with span("air.transcript"):
        transcript = Transcript(f"ezt-air/{air.name}")
        transcript.absorb("public", [len(publics)] + [int(v) % gl.P for v in publics])
        transcript.absorb("boundary",
                          [v for b in boundaries for v in (b.col, b.row, b.value % gl.P)])
        transcript.absorb("trace-root", root)
        n_alphas = sum(c.arity for c in air.constraints) + len(boundaries)
        alphas = transcript.challenges("alpha", n_alphas)

    with span("air.composition"):
        comp = _composition(air, lde_cols, alphas, boundaries, shift)
        stage("composition")
    with span("air.fri"):
        fri_out = fri.fri_prove(comp, shift, transcript, air.fri_params(num_queries))
        stage("fri")

    with span("air.openings"):
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
        stage("openings")

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


# ---------------------------------------------------------------------------
# verifier (host only)


def verify(air: Air, proof: dict, publics: List[int], boundaries: List[Boundary]) -> bool:
    try:
        n = int(proof["n"])
        C = int(proof["n_cols"])
        B = int(proof["ext_blowup"])
        shift = int(proof["shift"])
        num_queries = int(proof["num_queries"])
        root = [int(x) for x in proof["trace_root"]]
        p_pub = [int(v) for v in proof["publics"]]
        p_bnd = [(int(c), int(r), int(v)) for c, r, v in proof["boundaries"]]
    except (KeyError, ValueError, TypeError):
        return False
    if n != air.n or C != air.n_cols or B != air.ext_blowup:
        return False
    # the proof must be for the instance the caller is checking
    if p_pub != [int(v) % gl.P for v in publics]:
        return False
    if p_bnd != [(b.col, b.row, b.value % gl.P) for b in boundaries]:
        return False
    m = n * B

    transcript = Transcript(f"ezt-air/{air.name}")
    transcript.absorb("public", [len(publics)] + [int(v) % gl.P for v in publics])
    transcript.absorb("boundary", [v for b in boundaries for v in (b.col, b.row, b.value % gl.P)])
    transcript.absorb("trace-root", root)
    n_con_alphas = sum(c.arity for c in air.constraints)
    alphas = transcript.challenges("alpha", n_con_alphas + len(boundaries))

    ok, layer0 = fri.fri_verify(proof["fri"], transcript, air.fri_params(num_queries))
    if not ok or int(proof["fri"]["domain_size"]) != m:
        return False
    if len(proof["trace_openings"]) != len(layer0):
        return False

    w_m = gl.primitive_root_of_unity(m)
    w_n = gl.primitive_root_of_unity(n)
    w_last = gl.h_pow(w_n, n - 1)
    alg = HostAlg()

    # every periodic column at every needed point in one numpy pass
    xs = []
    for jj, _, _ in layer0:
        x = gl.h_mul(shift, gl.h_pow(w_m, jj))
        xs += [x, (gl.P - x) % gl.P]
    per_all = air.periodic_at_many(xs)  # (K, 2Q)

    def composition_at(x, cur_vals, nxt_vals, per_vals) -> int:
        zh_inv = gl.h_inv((gl.h_pow(x, n) - 1) % gl.P)
        last_fac = (x - w_last) % gl.P
        comp = 0
        off = 0
        for c in air.constraints:
            v = c.fn(alg, cur_vals, nxt_vals, per_vals)
            vals = [int(x_) for x_ in np.atleast_1d(np.asarray(v, dtype=np.uint64))]
            if len(vals) != c.arity:
                raise ValueError(f"{c.name}: arity mismatch")
            for i, vi in enumerate(vals):
                if c.domain == "transition":
                    q = vi * last_fac % gl.P * zh_inv % gl.P
                else:
                    q = vi * zh_inv % gl.P
                comp = (comp + alphas[off + i] * q) % gl.P
            off += c.arity
        for j, b in enumerate(boundaries):
            den = (x - gl.h_pow(w_n, b.row)) % gl.P
            q = (int(cur_vals[b.col]) - b.value) % gl.P * gl.h_inv(den) % gl.P
            comp = (comp + alphas[n_con_alphas + j] * q) % gl.P
        return comp

    for qi, (rows_open, (jj, u_val, v_val)) in enumerate(zip(proof["trace_openings"], layer0)):
        if len(rows_open) != 4:
            return False
        expect_idx = [jj, (jj + B) % m, jj + m // 2, (jj + m // 2 + B) % m]
        vals = {}
        for entry, want_i in zip(rows_open, expect_idx):
            i = int(entry["index"])
            if i != want_i:
                return False
            row = [int(x) for x in entry["row"]]
            if len(row) != C:
                return False
            path = [[int(x) for x in p] for p in entry["path"]]
            if not merkle.verify_path(root, i, row, path):
                return False
            vals[i] = row
        x_u = gl.h_mul(shift, gl.h_pow(w_m, jj))
        x_v = (gl.P - x_u) % gl.P
        per_u = [int(v) for v in per_all[:, 2 * qi]]
        per_v = [int(v) for v in per_all[:, 2 * qi + 1]]
        c_u = composition_at(x_u, vals[jj], vals[(jj + B) % m], per_u)
        c_v = composition_at(x_v, vals[jj + m // 2], vals[(jj + m // 2 + B) % m], per_v)
        if c_u != u_val or c_v != v_val:
            return False
    return True
