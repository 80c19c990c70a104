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

With a mesh, `prove_chunks` splits the K chunks over the mesh's chunk
axis: K is padded with dummy chunks to a multiple of the axis (their
proofs dropped, as in the JAX package), each position proves its
contiguous share on its own device, one position after the other (one
controller; the card works behind the host's launches), and since every
chunk's transcript is its own the proofs are the serial ones.

The JAX module's `commit_leaves_batched` and `_fold_phase` have no
counterparts of their own: `merkle.commit_leaves` and `fri.fold_layer`
take the leading chunk axis (a (K, 1) β folds each chunk with its own).
The batched FRI prover itself is `fri.fri_prove_batched`; the AIR prover
takes its K = 1 case.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import ntt as nttm
from ..utils.profiling import span
from . import fri, merkle
from .fri import path_strs
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


def prove_chunks(datas: List[List[int]], ivs: List[int], params: StarkParams | None = None,
                 n: int | None = None, *, device=None, mesh=None) -> List[dict]:
    """Prove K chunks at once on `device`; the proofs equal
    [stark.prove_chunk(d, iv, params, n_rows=n) for d, iv in zip(datas, ivs)]
    of the JAX package.  All chunks share the trace size n (default: the
    size the serial prover would pick for the longest chunk).  With a mesh
    (parallel.mesh.Mesh) the chunks are split over its chunk axis and
    `device` is not used."""
    params = params or StarkParams()
    K = len(datas)
    assert K >= 1 and len(ivs) == K
    if n is None:
        longest = max(len(d) for d in datas)
        n = max(4, 1 << longest.bit_length())
    assert all(len(d) <= n - 1 for d in datas)
    if mesh is not None:
        return _prove_over_mesh(datas, ivs, params, n, mesh)
    if device is None:
        raise TypeError("prove_chunks needs a device or a mesh")
    gamma = chunk_gamma()
    m = n * params.blowup

    with span("stark.trace"):
        d_np = np.zeros((K, n), dtype=np.uint64)
        for k, d in enumerate(datas):
            d_np[k, : len(d)] = [int(x) % gl.P for x in d]
        iv_host = [iv % gl.P for iv in ivs]
        iv_t = gl.from_int(iv_host, device)
        A_lde, D_lde, rows, out_t = _trace_phase(
            gl.from_int(d_np, device), iv_t, blowup=params.blowup, gamma=gamma,
            shift=params.shift,
        )
        outs = [int(v) for v in gl.to_int(out_t)]
    with span("stark.commit"):
        levels = merkle.commit_leaves(rows)
        trace_roots = merkle.roots(levels)

    with span("stark.transcript"):
        transcripts = []
        alphas = np.zeros((K, 3), dtype=np.uint64)
        for k in range(K):
            t = Transcript("ezt-chunk-stark")
            t.absorb("public", [n, iv_host[k], outs[k], gamma])
            t.absorb("trace-root", [int(x) for x in trace_roots[k]])
            alphas[k] = t.challenges("alpha", 3)
            transcripts.append(t)

    with span("stark.composition"):
        comp = _composition_phase(
            A_lde, D_lde, gl.from_int(alphas, device), iv_t, out_t,
            n=n, blowup=params.blowup, gamma=gamma, shift=params.shift,
        )
    fri_outs = fri.fri_prove_batched(comp, params.shift, transcripts, params.fri_params())

    with span("stark.openings"):
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
                        "path": path_strs(paths[k, i]),
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


def _prove_over_mesh(datas, ivs, params: StarkParams, n: int, mesh) -> List[dict]:
    """K chunks split over the mesh's chunk axis: K padded with dummy chunks
    to a multiple of the axis, each position's contiguous share proved on
    its device, the dummies' proofs dropped."""
    devices = mesh.chunk_devices()
    K = len(datas)
    pad = (-K) % len(devices)
    datas, ivs = list(datas) + [[0]] * pad, list(ivs) + [0] * pad
    share = len(datas) // len(devices)
    proofs = []
    for i, dev in enumerate(devices):
        part = slice(i * share, (i + 1) * share)
        proofs += prove_chunks(datas[part], ivs[part], params, n, device=dev)
    return proofs[:K]
