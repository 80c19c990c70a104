"""The FRI low-degree test's prover: K same-size arity-2 FRIs at once over
(K, m) coset evaluations, each with its own transcript.  Fold:
f'(x^2) = (f(x) + f(-x))/2 + beta*(f(x) - f(-x))/(2x) over the pairs
(j, j + m/2) of an m-point coset domain s*H."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from . import gl, merkle
from . import ntt as nttm
from .transcript import Transcript

INV2 = (gl.P + 1) // 2  # 1/2 mod p


@dataclass
class FriParams:
    blowup: int = 4
    num_queries: int = 30
    terminal_size: int = 64
    arity: int = 2
    # proof-of-work bits before the query draw; the Goldilocks provers keep 0
    grind_bits: int = 0

    def layer_schedule(self, m: int) -> List[int]:
        """Per-committed-layer arities for a size-m domain."""
        assert self.arity & (self.arity - 1) == 0 and self.arity >= 2
        out: List[int] = []
        size = m
        while size > self.terminal_size:
            a = 2 if not out else min(self.arity, size // self.terminal_size)
            out.append(a)
            size //= a
        return out


@dataclass
class FriProverOutput:
    proof: dict
    layer0_indices: List[int]  # query pair-indices into the original domain


def fold_layer(evals: torch.Tensor, beta, shift: int) -> torch.Tensor:
    """One FRI fold along the last axis: (..., m) evaluations on s·H ->
    (..., m/2) on s²·H².  beta: a python int or an int64 tensor that
    broadcasts against (..., m/2) (one β per batch row)."""
    m = evals.shape[-1]
    half = m // 2
    u, v = evals[..., :half], evals[..., half:]
    w_inv = gl.h_inv(gl.primitive_root_of_unity(m))
    x_inv = gl.mul(gl.powers(w_inv, half, evals.device), gl.full((), gl.h_inv(shift), evals.device))
    if not isinstance(beta, torch.Tensor):
        beta = gl.full((), beta, evals.device)
    inv2 = gl.full((), INV2, evals.device)
    even = gl.mul(gl.add(u, v), inv2)
    odd = gl.mul(gl.mul(gl.mul(gl.sub(u, v), inv2), x_inv), beta)
    return gl.add(even, odd)


def path_strs(digs: np.ndarray) -> list:
    return [[str(x) for x in d] for d in digs]


def fri_prove_batched(evals: torch.Tensor, shift: int, transcripts: List[Transcript],
                      params: FriParams) -> List[FriProverOutput]:
    """K simultaneous arity-2 FRI proofs over (K, m) evaluations."""
    K, m = evals.shape
    assert m & (m - 1) == 0
    assert all(a == 2 for a in params.layer_schedule(m)), "arity-2 FRI only"
    assert params.grind_bits == 0, "the Goldilocks FRI prover does not grind"
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
        cur = fold_layer(cur, gl.from_int(betas, dev)[:, None], cur_shift)
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
                 "path": path_strs(paths[k, q])}
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


def fri_prove(evals: torch.Tensor, shift: int, transcript: Transcript,
              params: FriParams) -> FriProverOutput:
    """Commit and open one polynomial: (m,) coset evaluations in natural
    order.  Raises AssertionError when the terminal polynomial's degree is
    too high (the evaluations were not of low degree)."""
    assert evals.dim() == 1
    return fri_prove_batched(evals[None], shift, [transcript], params)[0]
