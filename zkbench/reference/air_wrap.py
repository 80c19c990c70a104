"""The wrap profile's attestation, checked: the plain verifier of a
wrap-profile AIR STARK (Poseidon2-Fr trees, the Fr transcript, the constants
tree of the periodic columns, FRI over Goldilocks) and the statement it
attests, worked out from the child's header.

`verify_many` gives each attestation's verdict, "accepted" or the reason it
is rejected, under pins that the caller takes from the deployment (chunk
queries, rows and terminal; wrap queries, grinding bits and blowup; the
constants root): the instance (publics and boundaries) is replayed from the
child's header by `recursion`, the transcript on host ints, the composition
at the query points evaluated once for all queries with the AIR's own
constraints, and every Merkle path of every attestation in one batch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from . import gl, merkle_fr, recursion
from .air import Air, DevAlg
from .fri import INV2
from .poseidon_fr import pack_gl
from .stark import chunk_gamma
from .transcript_fr import TranscriptFr

SHIFT = gl.MULTIPLICATIVE_GENERATOR
# the fields of a wrap proof that state what it attests and at which profile
STATEMENT = ("version", "kind", "air", "n", "n_cols", "ext_blowup", "shift", "num_queries",
             "grind_bits", "publics", "boundaries", "const_root")


@dataclass(frozen=True)
class Pins:
    """The deployment's values an attestation is held to."""

    chunk_rows: int
    chunk_queries: int
    terminal: int
    wrap_queries: int
    wrap_grind_bits: int
    wrap_blowup: int
    const_root: int | None

    @classmethod
    def of(cls, config: dict) -> "Pins":
        p = config["prover"]
        sp = p["stark_params"]
        rows = p["chunk_trace_rows"]
        root = config.get("constants_root")
        return cls(rows, sp["num_queries"], min(sp["terminal_size"], 4 * rows),
                   p["wrap_queries"], p["wrap_grind_bits"], p["wrap_blowup"],
                   None if root is None else int(root))

    def air(self) -> Air:
        base = recursion.attestation_air(self.chunk_rows, self.chunk_queries, self.terminal)[0]
        return wrap_air(base, self.wrap_blowup)


def wrap_air(air: Air, blowup: int) -> Air:
    return air if air.ext_blowup == blowup else dataclasses.replace(air, ext_blowup=blowup)


# ---------------------------------------------------------------------------
# the constants tree: the periodic columns at every point of the LDE coset


def constants_rows(air: Air, device, shift: int = SHIFT) -> torch.Tensor:
    return air.periodic_lde(shift, device).T


def constants_root(air: Air, device, shift: int = SHIFT) -> int:
    return merkle_fr.commit_root(constants_rows(air, device, shift))


def constants_root_host(air: Air, shift: int = SHIFT) -> int:
    rows = gl.to_int(constants_rows(air, torch.device("cpu"), shift))
    return merkle_fr.commit_root_host([[int(v) for v in r] for r in rows])


# ---------------------------------------------------------------------------
# the statement: what a child's attestation must state


class Rejected(Exception):
    pass


def instance(att: dict, pins: Pins):
    """(publics, boundaries) of the attestation's child, replayed from its
    header after the header is held to the pins."""
    header = att["header"]
    q_c, n_c = int(att["q_c"]), int(header["n"])
    if q_c != pins.chunk_queries:
        raise Rejected(f"chunk queries {q_c}, pinned {pins.chunk_queries}")
    if n_c != pins.chunk_rows:
        raise Rejected(f"chunk rows {n_c}, pinned {pins.chunk_rows}")
    if int(header["blowup"]) != 4:
        raise Rejected("child blowup")
    if int(header["public"]["gamma"]) != chunk_gamma():
        raise Rejected("child gamma")
    terminal = recursion.header_terminal(header)
    if terminal != pins.terminal:
        raise Rejected(f"child terminal {terminal}, pinned {pins.terminal}")
    if len(header.get("roots", [])) != recursion.n_fold_layers(n_c, terminal):
        raise Rejected("child fold-layer roots")
    if int(header["shift"]) != SHIFT:
        raise Rejected("child shift")
    alphas, betas, indices = recursion.replay_child(header, q_c)
    return recursion._instance(header, alphas, betas, indices)


def statement(att: dict, pins: Pins) -> dict:
    """The statement fields (`STATEMENT`) the attestation of this child
    must carry at the pins."""
    air = pins.air()
    publics, bnds = instance(att, pins)
    return {
        "version": 1,
        "kind": "air-wrap",
        "air": air.name,
        "n": air.n,
        "n_cols": air.n_cols,
        "ext_blowup": air.ext_blowup,
        "shift": str(SHIFT),
        "num_queries": pins.wrap_queries,
        "grind_bits": pins.wrap_grind_bits,
        "publics": [str(int(v) % gl.P) for v in publics],
        "boundaries": [[b.col, b.row, str(b.value % gl.P)] for b in bnds],
        "const_root": str(pins.const_root),
    }


# ---------------------------------------------------------------------------
# the verifier


def _alpha_powers(alpha: int, n: int) -> list:
    out, a = [], 1
    for _ in range(n):
        a = gl.h_mul(a, alpha)
        out.append(a)
    return out


def _horner(coeffs: list, x: int) -> int:
    val = 0
    for c in reversed(coeffs):
        val = (val * x + c) % gl.P
    return val


def _fri(fri: dict, t: TranscriptFr, blowup: int, queries: int, grind_bits: int, terminal: int,
         m: int, checks: list) -> list:
    """FRI over Fr trees on the host: every layer's fold and the terminal
    polynomial; each opening's path added to `checks`.  Returns layer 0's
    (pair index, u, v) a query."""
    if int(fri["domain_size"]) != m:
        raise Rejected("FRI domain size")
    shift = int(fri["shift"])
    roots = [int(r) for r in fri["roots"]]
    final = [int(c) for c in fri["final_coeffs"]]
    betas, sizes, shifts = [], [], []
    size, cur_shift = m, shift
    for r in roots:
        if size <= terminal:
            raise Rejected("FRI layer count")
        t.absorb("fri-root", [r])
        betas.append(t.challenge_gl("fri-beta"))
        sizes.append(size)
        shifts.append(cur_shift)
        size //= 2
        cur_shift = gl.h_mul(cur_shift, cur_shift)
    if size > terminal or len(final) != size // blowup:
        raise Rejected("FRI terminal size")
    t.absorb_packed_gl("fri-final", final)
    if grind_bits:
        nonce = int(fri.get("grind_nonce", -1))
        if nonce < 0 or not t.grind_check(nonce, grind_bits):
            raise Rejected("grinding nonce")
    indices = t.challenge_indices("fri-query", queries, m // 2)
    if len(fri["queries"]) != len(indices):
        raise Rejected("FRI query count")
    layer0 = []
    if not roots:
        w = gl.primitive_root_of_unity(m)
        for q, idx in zip(fri["queries"], indices):
            if int(q["index"]) != idx or q["layers"]:
                raise Rejected("FRI query index")
            xu = gl.h_mul(shift, gl.h_pow(w, idx))
            layer0.append((idx, _horner(final, xu), _horner(final, gl.P - xu)))
        return layer0
    for q, idx in zip(fri["queries"], indices):
        if int(q["index"]) != idx or len(q["layers"]) != len(roots):
            raise Rejected("FRI query index")
        j, expect = idx, None
        for li, layer in enumerate(q["layers"]):
            half = sizes[li] // 2
            jj = j % half
            u, v = int(layer["u"]), int(layer["v"])
            checks.append(merkle_fr.PathCheck(roots[li], jj, pack_gl([u, v]),
                                              [int(x) for x in layer["path"]]))
            if li == 0:
                layer0.append((jj, u, v))
            elif expect != (u if j < half else v):
                raise Rejected(f"FRI fold at layer {li}")
            w_inv = gl.h_inv(gl.primitive_root_of_unity(sizes[li]))
            x_inv = gl.h_mul(gl.h_inv(shifts[li]), gl.h_pow(w_inv, jj))
            even = (u + v) * INV2 % gl.P
            odd = (u - v) * INV2 % gl.P * x_inv % gl.P * betas[li] % gl.P
            expect, j = (even + odd) % gl.P, jj
        x = gl.h_mul(gl.h_mul(shifts[-1], shifts[-1]),
                     gl.h_pow(gl.primitive_root_of_unity(sizes[-1] // 2), j))
        if _horner(final, x) != expect:
            raise Rejected("FRI terminal value")
    return layer0


def _compositions(air: Air, points: list, alphas: list, bnds: list, device) -> list:
    """The composition at each (x, current row, next row, periodic row):
    the constraints evaluated once over all points (DevAlg on a (C, k)
    batch), the quotients on host ints."""
    k = len(points)
    cur = gl.from_int(np.array([p[1] for p in points], dtype=np.uint64).T, device)
    nxt = gl.from_int(np.array([p[2] for p in points], dtype=np.uint64).T, device)
    per = gl.from_int(np.array([p[3] for p in points], dtype=np.uint64).T, device)
    alg = DevAlg((k,), device)
    n = air.n
    w_n = gl.primitive_root_of_unity(n)
    w_last = gl.h_pow(w_n, n - 1)
    zh_inv = [gl.h_inv((gl.h_pow(p[0], n) - 1) % gl.P) for p in points]
    factor = {"all": zh_inv,
              "transition": [z * ((p[0] - w_last) % gl.P) % gl.P for z, p in zip(zh_inv, points)]}
    comp = [0] * k
    off = 0
    for c in air.constraints:
        vals = np.broadcast_to(gl.to_int(c.fn(alg, cur, nxt, per)), (c.arity, k))
        f = factor[c.domain]
        for i in range(c.arity):
            a = alphas[off + i]
            comp = [(s + a * (int(v) * fq % gl.P)) % gl.P for s, v, fq in zip(comp, vals[i], f)]
        off += c.arity
    for j, b in enumerate(bnds):
        for q, (x, row, _, _) in enumerate(points):
            v = (int(row[b.col]) - b.value) % gl.P * gl.h_inv((x - gl.h_pow(w_n, b.row)) % gl.P)
            comp[q] = (comp[q] + alphas[off + j] * v) % gl.P
    return comp


def _host_part(att: dict, pins: Pins, device, checks: list) -> None:
    """Everything of one attestation but its Merkle paths, which go to
    `checks`; raises Rejected."""
    if att.get("type") != "chunk-attested-wrap":
        raise Rejected(f"child type {att.get('type')!r}")
    if pins.const_root is None:
        raise Rejected("no pinned constants root")
    publics, bnds = instance(att, pins)
    air = pins.air()
    proof = att["wrap_proof"]
    try:
        n, C, B = int(proof["n"]), int(proof["n_cols"]), int(proof["ext_blowup"])
        shift, queries = int(proof["shift"]), int(proof["num_queries"])
        grind_bits = int(proof.get("grind_bits", 0))
        root, c_root = int(proof["trace_root"]), int(proof["const_root"])
        p_pub = [int(v) for v in proof["publics"]]
        p_bnd = [(int(c), int(r), int(v)) for c, r, v in proof["boundaries"]]
    except (KeyError, ValueError, TypeError) as e:
        raise Rejected(f"malformed wrap proof: {e!r}") from None
    if (n, C) != (air.n, air.n_cols):
        raise Rejected(f"trace shape {n} x {C}, the AIR's {air.n} x {air.n_cols}")
    if B != pins.wrap_blowup:
        raise Rejected(f"wrap blowup {B}, pinned {pins.wrap_blowup}")
    if queries != pins.wrap_queries:
        raise Rejected(f"wrap queries {queries}, pinned {pins.wrap_queries}")
    if grind_bits != pins.wrap_grind_bits:
        raise Rejected(f"grinding bits {grind_bits}, pinned {pins.wrap_grind_bits}")
    if shift != SHIFT:
        raise Rejected("coset shift")
    if p_pub != [int(v) % gl.P for v in publics]:
        raise Rejected("publics differ from the replayed instance")
    if p_bnd != [(b.col, b.row, b.value % gl.P) for b in bnds]:
        raise Rejected("boundaries differ from the replayed instance")
    if c_root != pins.const_root:
        raise Rejected("constants root differs from the pinned one")
    m = n * B

    t = TranscriptFr(f"ezt-air-wrap/{air.name}")
    t.absorb("public", [len(publics)] + [int(v) % gl.P for v in publics])
    t.absorb("boundary", [v for b in bnds for v in (b.col, b.row, b.value % gl.P)])
    t.absorb("const-root", [c_root])
    t.absorb("trace-root", [root])
    n_con = sum(c.arity for c in air.constraints)
    alphas = _alpha_powers(t.challenge_gl("alpha"), n_con + len(bnds))

    fp = air.fri_params(queries, grind_bits)
    layer0 = _fri(proof["fri"], t, fp.blowup, queries, grind_bits, fp.terminal_size, m, checks)
    if len(proof["trace_openings"]) != len(layer0) or len(proof["const_openings"]) != len(layer0):
        raise Rejected("opening count")

    K = len(air.periodic)
    w_m = gl.primitive_root_of_unity(m)
    points, want = [], []
    for rows_open, const_open, (jj, u, v) in zip(proof["trace_openings"], proof["const_openings"],
                                                 layer0):
        if len(rows_open) != 4 or len(const_open) != 2:
            raise Rejected("opening shape")
        vals = {}
        for entry, i in zip(rows_open, (jj, (jj + B) % m, jj + m // 2, (jj + m // 2 + B) % m)):
            row = [int(x) for x in entry["row"]]
            if int(entry["index"]) != i or len(row) != C:
                raise Rejected("trace opening index or width")
            checks.append(merkle_fr.PathCheck(root, i, pack_gl(row),
                                              [int(x) for x in entry["path"]]))
            vals[i] = row
        per = []
        for entry, i in zip(const_open, (jj, jj + m // 2)):
            row = [int(x) for x in entry["row"]]
            if int(entry["index"]) != i or len(row) != K:
                raise Rejected("constants opening index or width")
            checks.append(merkle_fr.PathCheck(c_root, i, pack_gl(row),
                                              [int(x) for x in entry["path"]]))
            per.append(row)
        x_u = gl.h_mul(shift, gl.h_pow(w_m, jj))
        points.append((x_u, vals[jj], vals[(jj + B) % m], per[0]))
        points.append(((gl.P - x_u) % gl.P, vals[jj + m // 2], vals[(jj + m // 2 + B) % m], per[1]))
        want += [u, v]
    if _compositions(air, points, alphas, bnds, device) != want:
        raise Rejected("composition differs from FRI's layer 0")


def verify_many(atts: list, pins: Pins, device) -> list[str]:
    """Each attestation's verdict: "accepted", or "rejected: <reason>"."""
    verdicts, checks, spans = [], [], []
    for att in atts:
        start = len(checks)
        try:
            _host_part(att, pins, device, checks)
            verdicts.append("accepted")
        except Rejected as e:
            verdicts.append(f"rejected: {e}")
            del checks[start:]
        except Exception as e:  # whatever breaks the verifier rejects the attestation
            verdicts.append(f"rejected: malformed attestation: {e!r}")
            del checks[start:]
        spans.append((start, len(checks)))
    ok = merkle_fr.verify_paths(checks, device)
    for k, (s, e) in enumerate(spans):
        if verdicts[k] == "accepted" and not all(ok[s:e]):
            verdicts[k] = f"rejected: Merkle path {ok[s:e].index(False)} of {e - s}"
    return verdicts
