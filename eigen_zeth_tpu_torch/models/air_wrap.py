"""Wrap-profile AIR STARK — port of eigen_zeth_tpu/models/air_wrap.py.

The attestation re-proven with SNARK-friendly commitments, so that the
Groth16 final wrap verifies it in-circuit (models/wrap_circuit.py).  The
mathematics is models/air.py's (the trace LDE, the same constraint families,
the composition in blocks, FRI folds) with three protocol substitutions:

  1. commitments are Poseidon2-Fr Merkle trees (models/merkle_fr.py) over
     rows packed 3 Goldilocks values to an Fr element, committed on the
     card by kernel F;
  2. the transcript is a Poseidon2-Fr duplex sponge
     (models/transcript_fr.py), and the constraint alphas are the powers
     of one challenge;
  3. the periodic columns are committed once per (AIR, shift) as a
     constants tree over the LDE coset's rows and opened at the query
     points.

The proof JSON equals the JAX package's byte for byte.  `prove_wrap` runs on
the trace's device and reports its stages through `air.stage` (lde, merkle,
composition, fri, grind, openings); `verify_wrap` is host math, the
reference the R1CS circuit mirrors gadget for gadget.
"""

from __future__ import annotations

import hashlib
from typing import List

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import ntt as nttm
from ..utils.profiling import span
from . import fri as fri_m
from . import merkle_fr
from .air import Air, Boundary, HostAlg, _composition, stage
from .transcript_fr import TranscriptFr

INV2 = fri_m.INV2


# ---------------------------------------------------------------------------
# constants tree (periodic columns committed per (air, shift))


def constants_rows(air: Air, shift: int, device) -> torch.Tensor:
    """(m, K) canonical periodic values at every LDE position — row j is
    every periodic column at x_j = shift·w_m^j: the LDE of the tiled
    patterns, read through its strides."""
    return air.periodic_lde(shift, device).T


_CONST_TREES: dict = {}  # (AIR shape and patterns, shift, device) -> MerkleTreeFr


def _const_key(air: Air, shift: int) -> tuple:
    """What the constants tree depends on: the AIR's shape, its periodic
    patterns and the shift (an AIR rebuilt by `dataclasses.replace` shares
    it)."""
    h = hashlib.sha256()
    for p in air.periodic:
        h.update(np.asarray(p, dtype=np.uint64).tobytes())
        h.update(b"|")
    return (air.name, air.n, air.n_cols, air.ext_blowup, shift, h.hexdigest())


def constants_tree(air: Air, shift: int, device) -> merkle_fr.MerkleTreeFr:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:  # "cuda" and a tensor's "cuda:0" share a tree
        dev = torch.device("cuda", torch.cuda.current_device())
    key = _const_key(air, shift) + (dev,)
    if key not in _CONST_TREES:
        _CONST_TREES[key] = merkle_fr.commit_rows_gl(constants_rows(air, shift, device))
    return _CONST_TREES[key]


def constants_root(air: Air, shift: int, device) -> int:
    """The constants root, its tree committed on `device` once."""
    return constants_tree(air, shift, device).root()


# ---------------------------------------------------------------------------
# FRI with Fr trees


def _fri_prove_fr(evals: torch.Tensor, shift: int, transcript: TranscriptFr,
                  params: fri_m.FriParams):
    m = evals.shape[-1]
    assert m & (m - 1) == 0
    dev = evals.device
    layers = []  # (tree, u, v) per committed layer
    roots: List[int] = []
    cur = evals
    cur_shift = shift
    while cur.shape[-1] > params.terminal_size:
        with span("fri.layer", layer=len(layers)):
            half = cur.shape[-1] // 2
            u, v = cur[:half], cur[half:]
            # leaf j = packed (u_j, v_j): one Fr element per leaf
            tree = merkle_fr.commit_rows_gl(torch.stack([u, v], dim=1))
            root = tree.root()
            with span("fri.transcript"):
                transcript.absorb("fri-root", [root])
                beta = transcript.challenge_gl("fri-beta")
            layers.append((tree, u, v))
            roots.append(root)
            cur = fri_m.fold_layer(cur, beta, cur_shift)
            cur_shift = gl.h_mul(cur_shift, cur_shift)

    with span("fri.terminal"):
        final_evals = gl.to_int(cur)
        tsize = len(final_evals)
        coeffs_shifted = gl.to_int(nttm.intt(cur))
        s_inv = gl.h_inv(cur_shift)
        final_coeffs, si = [], 1
        for c in coeffs_shifted:
            final_coeffs.append(gl.h_mul(int(c), si))
            si = gl.h_mul(si, s_inv)
        keep = tsize // params.blowup
        assert all(c == 0 for c in final_coeffs[keep:]), "terminal degree too high"
        final_coeffs = final_coeffs[:keep]
        transcript.absorb_packed_gl("fri-final", final_coeffs)
        stage("fri")

    with span("air.grind"):
        grind_nonce = None
        if params.grind_bits:
            grind_nonce = transcript.grind(params.grind_bits, device=dev)
        stage("grind")

    with span("fri.openings"):
        indices = transcript.challenge_indices("fri-query", params.num_queries, m // 2)
        js = np.asarray(indices, dtype=np.int64)
        per_layer = []
        for tree, u, v in layers:
            jj = js % u.shape[0]
            idx = torch.from_numpy(jj).to(dev)
            uv = gl.to_int(torch.stack([u[idx], v[idx]], dim=1))  # one transfer
            per_layer.append((uv, tree.open_many(jj.tolist())))
            js = jj
        queries = []
        for q, idx in enumerate(indices):
            layer_openings = [
                {"u": str(int(uv[q, 0])), "v": str(int(uv[q, 1])),
                 "path": [str(x) for x in paths[q]]}
                for uv, paths in per_layer
            ]
            queries.append({"index": idx, "layers": layer_openings})

    proof = {
        "domain_size": m,
        "shift": str(shift),
        "roots": [str(r) for r in roots],
        "final_coeffs": [str(c) for c in final_coeffs],
        "queries": queries,
    }
    if grind_nonce is not None:
        proof["grind_nonce"] = str(grind_nonce)
    return proof, indices


def _fri_verify_fr(proof: dict, transcript: TranscriptFr, params: fri_m.FriParams):
    """Host mirror of fri.fri_verify over Fr trees.  Returns
    (ok, [(pair_index, u, v)] at layer 0)."""
    m = int(proof["domain_size"])
    shift = int(proof["shift"])
    roots = [int(r) for r in proof["roots"]]
    final_coeffs = [int(c) for c in proof["final_coeffs"]]

    betas, sizes, shifts = [], [], []
    size, cur_shift = m, shift
    for r in roots:
        if size <= params.terminal_size:
            return False, []
        transcript.absorb("fri-root", [r])
        betas.append(transcript.challenge_gl("fri-beta"))
        sizes.append(size)
        shifts.append(cur_shift)
        size //= 2
        cur_shift = gl.h_mul(cur_shift, cur_shift)
    if size > params.terminal_size:
        return False, []
    if len(final_coeffs) != size // params.blowup:
        return False, []
    transcript.absorb_packed_gl("fri-final", final_coeffs)
    if params.grind_bits:
        nonce = int(proof.get("grind_nonce", -1))
        if nonce < 0 or not transcript.grind_check(nonce, params.grind_bits):
            return False, []
    indices = transcript.challenge_indices("fri-query", params.num_queries, m // 2)
    if len(proof["queries"]) != len(indices):
        return False, []
    layer0 = []
    if not roots:
        w = gl.primitive_root_of_unity(m)
        half = m // 2

        def ev(x):
            val = 0
            for co in reversed(final_coeffs):
                val = (val * x + co) % gl.P
            return val

        for q, idx in zip(proof["queries"], indices):
            if int(q["index"]) != idx or q["layers"]:
                return False, []
            xu = gl.h_mul(shift, gl.h_pow(w, idx))
            xv = gl.h_mul(shift, gl.h_pow(w, idx + half))
            layer0.append((idx, ev(xu), ev(xv)))
        return True, layer0
    for q, idx in zip(proof["queries"], indices):
        if int(q["index"]) != idx or len(q["layers"]) != len(roots):
            return False, []
        j = idx
        prev_expected = None
        for li, layer in enumerate(q["layers"]):
            half = sizes[li] // 2
            jj = j % half
            u, v = int(layer["u"]), int(layer["v"])
            path = [int(x) for x in layer["path"]]
            if not merkle_fr.verify_path_gl(roots[li], jj, [u, v], path):
                return False, []
            if li == 0:
                layer0.append((jj, u, v))
            else:
                got = u if j < half else v
                if prev_expected != got:
                    return False, []
            beta = betas[li]
            w_inv = gl.h_inv(gl.primitive_root_of_unity(sizes[li]))
            x_inv = gl.h_mul(gl.h_inv(shifts[li]), gl.h_pow(w_inv, jj))
            even = (u + v) * INV2 % gl.P
            odd = (u - v) * INV2 % gl.P * x_inv % gl.P * beta % gl.P
            prev_expected = (even + odd) % gl.P
            j = jj
        t_size = sizes[-1] // 2
        t_shift = gl.h_mul(shifts[-1], shifts[-1])
        w = gl.primitive_root_of_unity(t_size)
        x = gl.h_mul(t_shift, gl.h_pow(w, j))
        val = 0
        for c in reversed(final_coeffs):
            val = (val * x + c) % gl.P
        if val != prev_expected:
            return False, []
    return True, layer0


# ---------------------------------------------------------------------------
# prover


def n_alphas_of(air: Air, boundaries: List[Boundary]) -> int:
    return sum(c.arity for c in air.constraints) + len(boundaries)


def alpha_powers(alpha: int, n: int) -> List[int]:
    out, a = [], 1
    for _ in range(n):
        a = gl.h_mul(a, alpha)
        out.append(a)
    return out


def _absorb_instance(t: TranscriptFr, publics, boundaries, c_root: int, root: int) -> None:
    t.absorb("public", [len(publics)] + [int(v) % gl.P for v in publics])
    t.absorb("boundary", [v for b in boundaries for v in (b.col, b.row, b.value % gl.P)])
    t.absorb("const-root", [c_root])
    t.absorb("trace-root", [root])


def prove_wrap(air: Air, trace_rows: torch.Tensor, publics: List[int], boundaries: List[Boundary],
               num_queries: int = 4, shift: int = gl.MULTIPLICATIVE_GENERATOR,
               grind_bits: int = 0) -> dict:
    """Wrap-profile STARK proof (Fr commitments, Fr transcript) of an
    (n, n_cols) int64 trace of canonical words, made on the trace's device.

    grind_bits adds EthSTARK-style proof of work before the query draw
    (about 2^g permutations for the prover, one conjectured soundness bit
    each for the verifier)."""
    n, C = trace_rows.shape
    assert n == air.n and C == air.n_cols
    B = air.ext_blowup
    m = n * B
    dev = trace_rows.device

    with span("air.lde"):
        lde_cols = nttm.lde_columns(trace_rows.T, B, shift)  # (C, m)
        stage("lde")
    with span("air.merkle"):
        tree = merkle_fr.commit_rows_gl(lde_cols.T)  # rows (m, C), read through their strides
        root = tree.root()
        c_root = constants_root(air, shift, dev)
        stage("merkle")

    with span("air.transcript"):
        t = TranscriptFr(f"ezt-air-wrap/{air.name}")
        _absorb_instance(t, publics, boundaries, c_root, root)
        alpha = t.challenge_gl("alpha")
        alphas = alpha_powers(alpha, n_alphas_of(air, boundaries))

    with span("air.composition"):
        comp = _composition(air, lde_cols, alphas, boundaries, shift)
        stage("composition")

    with span("air.fri"):  # FRI's layers, the grinding and FRI's openings
        fri_proof, indices = _fri_prove_fr(comp, shift, t, air.fri_params(num_queries, grind_bits))

    with span("air.openings"):
        all_idx = []
        for jj in indices:
            all_idx += [jj, (jj + B) % m, jj + m // 2, (jj + m // 2 + B) % m]
        idx_t = torch.as_tensor(all_idx, dtype=torch.int64, device=dev)
        row_vals = gl.to_int(lde_cols[:, idx_t].T)  # (4Q, C), one transfer
        all_paths = tree.open_many(all_idx)
        openings = []
        for q in range(len(indices)):
            openings.append([
                {
                    "index": int(all_idx[i]),
                    "row": [str(int(x)) for x in row_vals[i]],
                    "path": [str(x) for x in all_paths[i]],
                }
                for i in range(4 * q, 4 * q + 4)
            ])

        # constants openings at jj and jj + m/2 (periodic values at x and -x)
        c_tree = constants_tree(air, shift, dev)
        c_idx = [i for jj in indices for i in (jj, jj + m // 2)]
        c_vals = gl.to_int(constants_rows(air, shift, dev)[torch.as_tensor(c_idx, device=dev)])
        c_paths = c_tree.open_many(c_idx)
        const_openings = []
        for q in range(len(indices)):
            const_openings.append([
                {
                    "index": int(c_idx[i]),
                    "row": [str(int(v)) for v in np.atleast_1d(c_vals[i])],
                    "path": [str(x) for x in c_paths[i]],
                }
                for i in (2 * q, 2 * q + 1)
            ])
        stage("openings")

    return {
        "version": 1,
        "kind": "air-wrap",
        "air": air.name,
        "n": n,
        "n_cols": C,
        "ext_blowup": B,
        "shift": str(shift),
        "num_queries": num_queries,
        "grind_bits": grind_bits,
        "publics": [str(int(v) % gl.P) for v in publics],
        "boundaries": [[b.col, b.row, str(b.value % gl.P)] for b in boundaries],
        "const_root": str(c_root),
        "trace_root": str(root),
        "fri": fri_proof,
        "trace_openings": openings,
        "const_openings": const_openings,
    }


# ---------------------------------------------------------------------------
# verifier (host reference; the R1CS circuit mirrors this function)


def verify_wrap(air: Air, proof: dict, publics: List[int], boundaries: List[Boundary],
                expected_queries: "int | None" = None,
                expected_grind_bits: "int | None" = None, *, device) -> bool:
    """expected_queries / expected_grind_bits pin the wrap STARK's own
    soundness parameters (the protocol's, not the proof's claim, or a
    forger could present a 1-query wrap).  `device` commits the constants
    tree (once per device); the rest is host math."""
    try:
        n = int(proof["n"])
        C = int(proof["n_cols"])
        B = int(proof["ext_blowup"])
        shift = int(proof["shift"])
        num_queries = int(proof["num_queries"])
        grind_bits = int(proof.get("grind_bits", 0))
        root = int(proof["trace_root"])
        c_root = int(proof["const_root"])
        p_pub = [int(v) for v in proof["publics"]]
        p_bnd = [(int(c), int(r), int(v)) for c, r, v in proof["boundaries"]]
    except (KeyError, ValueError, TypeError):
        return False
    if n != air.n or C != air.n_cols or B != air.ext_blowup:
        return False
    if expected_queries is not None and num_queries != expected_queries:
        return False
    if expected_grind_bits is not None and grind_bits != expected_grind_bits:
        return False
    if p_pub != [int(v) % gl.P for v in publics]:
        return False
    if p_bnd != [(b.col, b.row, b.value % gl.P) for b in boundaries]:
        return False
    if c_root != constants_root(air, shift, device):
        return False
    m = n * B

    t = TranscriptFr(f"ezt-air-wrap/{air.name}")
    _absorb_instance(t, publics, boundaries, c_root, root)
    alpha = t.challenge_gl("alpha")
    n_con_alphas = sum(c.arity for c in air.constraints)
    alphas = alpha_powers(alpha, n_con_alphas + len(boundaries))

    ok, layer0 = _fri_verify_fr(proof["fri"], t, air.fri_params(num_queries, grind_bits))
    if not ok or int(proof["fri"]["domain_size"]) != m:
        return False
    if len(proof["trace_openings"]) != len(layer0):
        return False
    if len(proof["const_openings"]) != len(layer0):
        return False

    w_m = gl.primitive_root_of_unity(m)
    w_n = gl.primitive_root_of_unity(n)
    w_last = gl.h_pow(w_n, n - 1)
    alg = HostAlg()

    def composition_at(x, cur_vals, nxt_vals, per_vals) -> int:
        zh = (gl.h_pow(x, n) - 1) % gl.P
        zh_inv = gl.h_inv(zh)
        comp = 0
        last_fac = (x - w_last) % gl.P
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

    K = len(air.periodic)
    for rows_open, const_open, (jj, u_val, v_val) in zip(
        proof["trace_openings"], proof["const_openings"], layer0
    ):
        if len(rows_open) != 4 or len(const_open) != 2:
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
            path = [int(x) for x in entry["path"]]
            if not merkle_fr.verify_path_gl(root, i, row, path):
                return False
            vals[i] = row
        per_uv = []
        for entry, want_i in zip(const_open, (jj, jj + m // 2)):
            i = int(entry["index"])
            if i != want_i:
                return False
            row = [int(x) for x in entry["row"]]
            if len(row) != K:
                return False
            path = [int(x) for x in entry["path"]]
            if not merkle_fr.verify_path_gl(c_root, i, row, path):
                return False
            per_uv.append(row)
        x_u = gl.h_mul(shift, gl.h_pow(w_m, jj))
        x_v = (gl.P - x_u) % gl.P
        c_u = composition_at(x_u, vals[jj], vals[(jj + B) % m], per_uv[0])
        c_v = composition_at(x_v, vals[jj + m // 2], vals[(jj + m // 2 + B) % m], per_uv[1])
        if c_u != u_val or c_v != v_val:
            return False
    return True
