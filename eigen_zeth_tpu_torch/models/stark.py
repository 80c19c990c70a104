r"""STARK chunk prover — port of eigen_zeth_tpu/models/stark.py.

The AIR is the JAX package's rolling-hash accumulator:

    columns  D (data), A (accumulator)
    boundary A(1) = iv,  A(w^{n-1}) = out
    step     A(w·x) = γ·A(x) + D(x)   on H \ {last row}

composition C = α1·Q1 + α2·Q2 + α3·Q3, FRI-proven on the blowup coset.

Here: `StarkParams`, the host `build_trace`, the host verifier
`verify_chunk` (a copy), and `prove_chunk` as the K = 1 case of the batched
device prover (models/stark_batch.py).  The JAX package's numpy diversion
for small chunks answers the TPU's compile cost and is not carried over:
every chunk proof runs on the given device.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops import goldilocks as gl
from . import fri, merkle
from .poseidon_tags import chunk_gamma
from .transcript import Transcript


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


def build_trace(data: list[int], iv: int, n: int | None = None):
    """Pad data into the first n-1 rows and run the accumulator column.
    Returns (d_column, a_column, out) as host ints."""
    gamma = chunk_gamma()
    d = [int(x) % gl.P for x in data]
    if n is None:
        n = max(4, 1 << len(d).bit_length()) if d else 4
    assert len(d) <= n - 1, "data must leave the last trace row free"
    d = d + [0] * (n - len(d))
    a = [iv % gl.P]
    for i in range(n - 1):
        a.append((a[-1] * gamma + d[i]) % gl.P)
    return d, a, a[-1]


def prove_chunk(data: list[int], iv: int, params: StarkParams | None = None,
                n_rows: int | None = None, *, device) -> dict:
    """One chunk proof: prove_chunks on a batch of one."""
    from . import stark_batch

    return stark_batch.prove_chunks([data], [iv], params, n=n_rows, device=device)[0]


def verify_chunk(proof: dict, params: StarkParams | None = None) -> bool:
    """Host-side verification of a chunk proof."""
    params = params or StarkParams()
    try:
        n = int(proof["n"])
        blowup = int(proof["blowup"])
        shift = int(proof["shift"])
        iv = int(proof["public"]["iv"])
        out = int(proof["public"]["out"])
        gamma = int(proof["public"]["gamma"])
        root = [int(x) for x in proof["trace_root"]]
    except (KeyError, ValueError):
        return False
    if blowup != params.blowup or shift != params.shift or gamma != chunk_gamma():
        return False
    m = n * blowup

    transcript = Transcript("ezt-chunk-stark")
    transcript.absorb("public", [n, iv, out, gamma])
    transcript.absorb("trace-root", root)
    alphas = transcript.challenges("alpha", 3)

    ok, layer0 = fri.fri_verify(proof["fri"], transcript, params.fri_params())
    if not ok:
        return False
    if int(proof["fri"]["domain_size"]) != m:
        return False

    w = gl.primitive_root_of_unity(m)
    w_last = gl.h_pow(gl.primitive_root_of_unity(n), n - 1)

    def composition_at(j: int, a_x: int, a_wx: int, d_x: int) -> int:
        x = gl.h_mul(shift, gl.h_pow(w, j))
        zh = (gl.h_pow(x, n) - 1) % gl.P
        c1 = (a_wx - gamma * a_x - d_x) % gl.P
        q1 = c1 * (x - w_last) % gl.P * gl.h_inv(zh) % gl.P
        q2 = (a_x - iv) % gl.P * gl.h_inv((x - 1) % gl.P) % gl.P
        q3 = (a_x - out) % gl.P * gl.h_inv((x - w_last) % gl.P) % gl.P
        return (alphas[0] * q1 + alphas[1] * q2 + alphas[2] * q3) % gl.P

    if len(proof["trace_openings"]) != len(layer0):
        return False
    for rows_open, (jj, u_val, v_val) in zip(proof["trace_openings"], layer0):
        if len(rows_open) != 4:
            return False
        expect_idx = [jj, (jj + blowup) % m, jj + m // 2, (jj + m // 2 + blowup) % m]
        vals = {}
        for entry, want_i in zip(rows_open, expect_idx):
            i = int(entry["index"])
            if i != want_i:
                return False
            row = [int(x) for x in entry["row"]]
            if len(row) != 2:
                return False
            path = [[int(x) for x in p] for p in entry["path"]]
            if not merkle.verify_path(root, i, row, path):
                return False
            vals[i] = row  # [A(x_i), D(x_i)]
        c_u = composition_at(jj, vals[jj][0], vals[(jj + blowup) % m][0], vals[jj][1])
        c_v = composition_at(
            jj + m // 2,
            vals[jj + m // 2][0],
            vals[(jj + m // 2 + blowup) % m][0],
            vals[jj + m // 2][1],
        )
        if c_u != u_val or c_v != v_val:
            return False
    return True
