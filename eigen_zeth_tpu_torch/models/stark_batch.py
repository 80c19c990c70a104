"""Batched chunk-STARK prover — port of eigen_zeth_tpu/models/stark_batch.py.

Proves K chunks at once: every device phase works on tensors with a
leading chunk axis K; the Fiat-Shamir transcripts stay per chunk on the
host, between the phases.  The proof dicts equal the JAX package's serial
prover's (`stark.prove_chunk`) field for field, so their JSON is
byte-identical.

  trace    rolling hash as a prefix sum: a_i = γ^i·(iv + Σ_{j<i} d_j·γ^{-(j+1)}),
           then batched INTT / coset LDE and one batched Merkle commit
  compose  C = α1·Q1 + α2·Q2 + α3·Q3 on the LDE coset with (K, 1)
           broadcasts; one batch inversion for the three denominators
  fri      per layer: batched commit -> K roots -> per-chunk β -> batched fold
  queries  per layer, one gather and one host transfer for all chunks

The JAX module's `commit_leaves_batched` and `_fold_phase` have no
counterparts of their own: `merkle.commit_leaves` and `fri.fold_layer`
take the leading chunk axis (a (K, 1) β folds each chunk with its own).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import ntt as nttm
from . import fri, merkle
from .fri import FriProverOutput
from .poseidon_tags import chunk_gamma
from .stark import StarkParams
from .transcript import Transcript


def _trace_phase(d: torch.Tensor, iv: torch.Tensor, *, blowup: int, gamma: int, shift: int):
    """(K, n) data + (K,) iv -> A/D LDEs (K, m), leaf rows (K, m, 2), out (K,)."""
    n = d.shape[-1]
    dev = d.device
    g_inv = gl.h_inv(gamma)
    gpow = gl.powers(gamma, n, dev)
    ginvp = gl.mul(gl.powers(g_inv, n, dev), gl.full((), g_inv, dev))
    incl = gl.scan(gl.add, gl.mul(d, ginvp))
    excl = torch.cat([torch.zeros_like(incl[:, :1]), incl[:, :-1]], dim=1)
    a = gl.mul(gpow, gl.add(iv[:, None], excl))
    out = a[:, -1]
    D_lde = nttm.lde(nttm.intt(d), blowup, shift)
    A_lde = nttm.lde(nttm.intt(a), blowup, shift)
    rows = torch.stack([A_lde, D_lde], dim=2)  # leaf = [A(x), D(x)]
    return A_lde, D_lde, rows, out


def _composition_phase(A_lde, D_lde, alphas, iv, out, *, n: int, blowup: int, gamma: int, shift: int):
    """(K, m) composition with per-chunk (K, 1) iv / out / alphas."""
    m = n * blowup
    dev = A_lde.device
    w_last = gl.h_pow(gl.primitive_root_of_unity(n), n - 1)
    x = gl.mul(gl.powers(gl.primitive_root_of_unity(m), m, dev), gl.full((), shift, dev))
    one = gl.full((), 1, dev)
    xw = gl.sub(x, gl.full((), w_last, dev))
    den = torch.stack([gl.sub(gl.pow_const(x, n), one), gl.sub(x, one), xw])
    zh_inv, x1_inv, xw_inv = gl.batch_inv(den)
    a_shift = torch.roll(A_lde, -blowup, dims=1)
    c1 = gl.sub(gl.sub(a_shift, gl.mul(A_lde, gl.full((), gamma, dev))), D_lde)
    q1 = gl.mul(gl.mul(c1, xw), zh_inv)
    q2 = gl.mul(gl.sub(A_lde, iv[:, None]), x1_inv)
    q3 = gl.mul(gl.sub(A_lde, out[:, None]), xw_inv)
    return gl.add(
        gl.add(gl.mul(q1, alphas[:, 0:1]), gl.mul(q2, alphas[:, 1:2])),
        gl.mul(q3, alphas[:, 2:3]),
    )


def _path_strs(digs: np.ndarray) -> list:
    return [[str(x) for x in d] for d in digs]


def fri_prove_batched(evals: torch.Tensor, shift: int, transcripts: List[Transcript],
                      params: fri.FriParams) -> List[FriProverOutput]:
    """K simultaneous arity-2 FRI proofs over (K, m) evaluations."""
    K, m = evals.shape
    assert m & (m - 1) == 0
    assert all(a == 2 for a in params.layer_schedule(m)), "arity-2 FRI only"
    dev = evals.device
    layers = []  # (levels, u, v) per committed layer
    roots_all = [[] for _ in range(K)]
    cur = evals
    cur_shift = shift
    while cur.shape[-1] > params.terminal_size:
        half = cur.shape[-1] // 2
        u, v = cur[:, :half], cur[:, half:]
        levels = merkle.commit_leaves(torch.stack([u, v], dim=2))
        roots = merkle.roots(levels)
        betas = []
        for k in range(K):
            root = [int(x) for x in roots[k]]
            transcripts[k].absorb("fri-root", root)
            roots_all[k].append(root)
            betas.append(transcripts[k].challenge("fri-beta"))
        layers.append((levels, u, v))
        cur = fri.fold_layer(cur, gl.from_int(betas, dev)[:, None], cur_shift)
        cur_shift = gl.h_mul(cur_shift, cur_shift)

    tsize = cur.shape[-1]
    coeffs_shifted = gl.to_int(nttm.intt(cur))
    s_inv = gl.h_inv(cur_shift)
    keep = tsize // params.blowup
    finals, indices = [], []
    for k in range(K):
        final_coeffs, si = [], 1
        for c in coeffs_shifted[k]:
            final_coeffs.append(gl.h_mul(int(c), si))
            si = gl.h_mul(si, s_inv)
        assert all(c == 0 for c in final_coeffs[keep:]), "terminal degree too high"
        final_coeffs = final_coeffs[:keep]
        transcripts[k].absorb("fri-final", final_coeffs)
        finals.append(final_coeffs)
        indices.append(transcripts[k].challenge_indices("fri-query", params.num_queries, m // 2))

    # openings: per layer one gather + transfer of values and of paths
    js = torch.as_tensor(indices, dtype=torch.int64, device=dev).reshape(K, -1)
    opened = []
    for levels, u, v in layers:
        jj = js % u.shape[-1]
        vals = gl.to_int(torch.stack([u.gather(1, jj), v.gather(1, jj)], dim=-1))
        opened.append((vals, merkle.open_batched(levels, jj)))
        js = jj
    outs = []
    for k in range(K):
        queries = []
        for q, idx in enumerate(indices[k]):
            layer_openings = [
                {"u": str(int(vals[k, q, 0])), "v": str(int(vals[k, q, 1])),
                 "path": _path_strs(paths[k, q])}
                for vals, paths in opened
            ]
            queries.append({"index": idx, "layers": layer_openings})
        proof = {
            "domain_size": m,
            "shift": str(shift),
            "roots": [[str(x) for x in r] for r in roots_all[k]],
            "final_coeffs": [str(c) for c in finals[k]],
            "queries": queries,
        }
        outs.append(FriProverOutput(proof=proof, layer0_indices=indices[k]))
    return outs


def prove_chunks(datas: List[List[int]], ivs: List[int], params: StarkParams | None = None,
                 n: int | None = None, *, device) -> List[dict]:
    """Prove K chunks at once on `device`; the proofs equal
    [stark.prove_chunk(d, iv, params, n_rows=n) for d, iv in zip(datas, ivs)]
    of the JAX package.  All chunks share the trace size n (default: the
    size the serial prover would pick for the longest chunk)."""
    params = params or StarkParams()
    K = len(datas)
    assert K >= 1 and len(ivs) == K
    gamma = chunk_gamma()
    if n is None:
        longest = max(len(d) for d in datas)
        n = max(4, 1 << longest.bit_length())
    assert all(len(d) <= n - 1 for d in datas)
    m = n * params.blowup

    d_np = np.zeros((K, n), dtype=np.uint64)
    for k, d in enumerate(datas):
        d_np[k, : len(d)] = [int(x) % gl.P for x in d]
    iv_host = [iv % gl.P for iv in ivs]
    iv_t = gl.from_int(iv_host, device)

    A_lde, D_lde, rows, out_t = _trace_phase(
        gl.from_int(d_np, device), iv_t, blowup=params.blowup, gamma=gamma, shift=params.shift
    )
    outs = [int(v) for v in gl.to_int(out_t)]
    levels = merkle.commit_leaves(rows)
    trace_roots = merkle.roots(levels)

    transcripts = []
    alphas = np.zeros((K, 3), dtype=np.uint64)
    for k in range(K):
        t = Transcript("ezt-chunk-stark")
        t.absorb("public", [n, iv_host[k], outs[k], gamma])
        t.absorb("trace-root", [int(x) for x in trace_roots[k]])
        alphas[k] = t.challenges("alpha", 3)
        transcripts.append(t)

    comp = _composition_phase(
        A_lde, D_lde, gl.from_int(alphas, device), iv_t, out_t,
        n=n, blowup=params.blowup, gamma=gamma, shift=params.shift,
    )
    fri_outs = fri_prove_batched(comp, params.shift, transcripts, params.fri_params())

    # trace openings: rows at x, w·x, -x, -w·x for every layer-0 query
    b = params.blowup
    all_idx = [
        [i for jj in fri_outs[k].layer0_indices
         for i in (jj, (jj + b) % m, jj + m // 2, (jj + m // 2 + b) % m)]
        for k in range(K)
    ]
    idx_t = torch.as_tensor(all_idx, dtype=torch.int64, device=device).reshape(K, -1)
    row_vals = gl.to_int(torch.gather(rows, 1, idx_t[..., None].expand(idx_t.shape + (2,))))
    paths = merkle.open_batched(levels, idx_t)
    proofs = []
    for k in range(K):
        openings = []
        for q in range(len(fri_outs[k].layer0_indices)):
            openings.append([
                {
                    "index": all_idx[k][i],
                    "row": [str(int(x)) for x in row_vals[k, i]],
                    "path": _path_strs(paths[k, i]),
                }
                for i in range(4 * q, 4 * q + 4)
            ])
        proofs.append({
            "version": 1,
            "n": n,
            "blowup": params.blowup,
            "shift": str(params.shift),
            "public": {"iv": str(iv_host[k]), "out": str(outs[k]), "gamma": str(gamma)},
            "trace_root": [str(x) for x in trace_roots[k]],
            "fri": fri_outs[k].proof,
            "trace_openings": openings,
        })
    return proofs
