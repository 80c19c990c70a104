"""FRI low-degree test — port of eigen_zeth_tpu/models/fri.py.

Carried over: `FriParams` (with its arity schedule), `FriProverOutput`, the
device fold `fold_layer`, the host verifier `fri_verify` and the
host-orchestrated prover: `fri_prove_batched` proves K same-size arity-2
FRIs at once (the chunk STARKs), and `fri_prove`, the single-polynomial
prover of the AIR path, is its K = 1 case with the same wire format.  The
TPU package's padded layered prover and fused single-program prover answer
that backend's compile cost and are not carried over, and neither is the
prover side of arity > 2 (the verifier keeps it).

Fold: f'(x²) = (f(x) + f(-x))/2 + β·(f(x) - f(-x))/(2x) over the pairs
(j, j + m/2) of an m-point coset domain s·H.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import ntt as nttm
from ..utils.profiling import span
from . import merkle
from .transcript import Transcript

INV2 = (gl.P + 1) // 2  # 1/2 mod p


@dataclass
class FriParams:
    blowup: int = 4
    num_queries: int = 30
    terminal_size: int = 64
    arity: int = 2
    # proof-of-work bits before the query draw; only the Fr wrap pipeline of
    # the JAX package grinds, the Goldilocks provers here keep 0
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
        with span("fri.layer", layer=len(layers)):
            half = cur.shape[-1] // 2
            u, v = cur[:, :half], cur[:, half:]
            levels = merkle.commit_leaves(torch.stack([u, v], dim=2))
            roots = merkle.roots(levels)
            betas = []
            with span("fri.transcript"):
                for k in range(K):
                    root = [int(x) for x in roots[k]]
                    transcripts[k].absorb("fri-root", root)
                    roots_all[k].append(root)
                    betas.append(transcripts[k].challenge("fri-beta"))
            layers.append((levels, u, v))
            cur = fold_layer(cur, gl.from_int(betas, dev)[:, None], cur_shift)
            cur_shift = gl.h_mul(cur_shift, cur_shift)

    with span("fri.terminal"):
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
            indices.append(transcripts[k].challenge_indices("fri-query", params.num_queries,
                                                            m // 2))

    with span("fri.openings"):
        # per layer one gather + transfer of values and of paths
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


def fri_verify(proof: dict, transcript: Transcript, params: FriParams) -> tuple[bool, list]:
    """Host-side verification.  Returns (ok, layer0_openings) where
    layer0_openings = [(pair_index, u, v), ...] for the caller to
    cross-check against externally computed evaluations."""
    m = int(proof["domain_size"])
    shift = int(proof["shift"])
    roots = [[int(x) for x in r] for r in proof["roots"]]
    final_coeffs = [int(c) for c in proof["final_coeffs"]]

    schedule = params.layer_schedule(m)
    if len(roots) != len(schedule):
        return False, []
    betas = []
    sizes = []
    shifts = []
    size, cur_shift = m, shift
    for r, A in zip(roots, schedule):
        transcript.absorb("fri-root", r)
        betas.append(transcript.challenge("fri-beta"))
        sizes.append(size)
        shifts.append(cur_shift)
        size //= A
        cur_shift = gl.h_pow(cur_shift, A)
    if size > params.terminal_size:
        return False, []
    if len(final_coeffs) != size // params.blowup:
        return False, []
    transcript.absorb("fri-final", final_coeffs)
    indices = transcript.challenge_indices("fri-query", params.num_queries, m // 2)

    if len(proof["queries"]) != len(indices):
        return False, []
    layer0 = []
    if not roots:
        # zero-layer FRI (m <= terminal_size): the terminal polynomial IS
        # the committed function
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
            A = schedule[li]
            c = sizes[li] // A
            jj = j % c
            if A == 2:
                if "u" not in layer:
                    return False, []
                vals = [int(layer["u"]), int(layer["v"])]
            else:
                vals = [int(x) for x in layer.get("vals", [])]
                if len(vals) != A:
                    return False, []
            path = [[int(x) for x in d] for d in layer["path"]]
            if not merkle.verify_path(roots[li], jj, vals, path):
                return False, []
            if li == 0:
                layer0.append((jj, vals[0], vals[1]))
            elif prev_expected != vals[j // c]:
                return False, []
            b = betas[li]
            sz = sizes[li]
            sh = shifts[li]
            K = A
            cur_vals = vals
            while K > 1:
                w_inv = gl.h_inv(gl.primitive_root_of_unity(sz))
                sh_inv = gl.h_inv(sh)
                nxt = []
                for k in range(K // 2):
                    x_inv = gl.h_mul(sh_inv, gl.h_pow(w_inv, jj + k * c))
                    even = (cur_vals[k] + cur_vals[k + K // 2]) * INV2 % gl.P
                    diff = (cur_vals[k] - cur_vals[k + K // 2]) * INV2 % gl.P
                    odd = diff * x_inv % gl.P * b % gl.P
                    nxt.append((even + odd) % gl.P)
                cur_vals = nxt
                K //= 2
                sz //= 2
                sh = gl.h_mul(sh, sh)
                b = gl.h_mul(b, b)
            prev_expected = cur_vals[0]
            j = jj
        t_size = sizes[-1] // schedule[-1]
        t_shift = gl.h_pow(shifts[-1], schedule[-1])
        w = gl.primitive_root_of_unity(t_size)
        x = gl.h_mul(t_shift, gl.h_pow(w, j))
        val = 0
        for co in reversed(final_coeffs):
            val = (val * x + co) % gl.P
        if val != prev_expected:
            return False, []
    return True, layer0
