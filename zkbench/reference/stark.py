r"""The chunk STARK's prover, K chunks at once.  The AIR is a rolling-hash
accumulator over a data column D:

    columns  D (data), A (accumulator)
    boundary A(1) = iv,  A(w^{n-1}) = out
    step     A(w*x) = gamma*A(x) + D(x)   on H minus the last row

with the composition C = a1*Q1 + a2*Q2 + a3*Q3 proved by FRI on the blowup
coset.  Every device phase works on tensors with a leading chunk axis K;
the transcripts stay per chunk on the host, between the phases.

  trace    a_i = gamma^i*(iv + sum_{j<i} d_j*gamma^{-(j+1)}) as a prefix sum,
           then the INTT, the coset LDE and one batched Merkle commit
  compose  the three quotients on the LDE coset with (K, 1) broadcasts
  fri      per layer: commit, K roots, a beta per chunk, one batched fold
  queries  per layer one gather and one host transfer for all chunks
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from . import fri, gl, merkle
from . import ntt as nttm
from .fri import path_strs
from .poseidon import _sha_to_field
from .transcript import Transcript


@functools.lru_cache(maxsize=1)
def chunk_gamma() -> int:
    """The rolling-hash multiplier of the chunk AIR."""
    return _sha_to_field("ezt-chunk-air/gamma")


@dataclass
class StarkParams:
    blowup: int = 4
    num_queries: int = 30
    terminal_size: int = 64
    shift: int = gl.MULTIPLICATIVE_GENERATOR
    fri_arity: int = 2

    def fri_params(self) -> fri.FriParams:
        return fri.FriParams(
            blowup=self.blowup,
            num_queries=self.num_queries,
            terminal_size=self.terminal_size,
            arity=self.fri_arity,
        )


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


def prove_chunks(datas: List[List[int]], ivs: List[int], params: StarkParams, n: int, *,
                 device) -> List[dict]:
    """Prove K chunks of at most n - 1 elements at once on `device`, one
    proof dict per chunk; all chunks share the trace size n."""
    K = len(datas)
    assert K >= 1 and len(ivs) == K
    assert all(len(d) <= n - 1 for d in datas)
    gamma = chunk_gamma()
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
    fri_outs = fri.fri_prove_batched(comp, params.shift, transcripts, params.fri_params())

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
