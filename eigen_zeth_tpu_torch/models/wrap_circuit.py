"""In-circuit verification of a wrap-profile STARK — port of
eigen_zeth_tpu/models/wrap_circuit.py.

`build_wrap_verifier` mirrors air_wrap.verify_wrap step for step with the
gadgets of models/r1cs_builder.py:

  1. Fiat-Shamir replay: a Poseidon2-Fr sponge gadget absorbs the same
     sequence; the alpha, the FRI betas and the query indices are squeezed
     with canonical 254-bit decompositions (a strict < r check makes the
     bits unique), and the index bits double as Merkle direction bits.
  2. Openings: trace rows, constants-tree rows and FRI pairs enter as packed
     Fr wires whose 64-bit unpack decompositions are the range proofs the
     lazy Goldilocks arithmetic needs; each path level is one permutation.
  3. The composition is recomputed by the AIR's own constraint definitions
     run against `R1CSAlg`, whose values are lazy Goldilocks wires.
  4. FRI: per layer a packed pair opening, the fold relation
     2·x_l·next == x_l·(u+v) + beta_l·(u-v), index chaining by bit
     truncation, and the terminal Horner.
  5. The single Groth16 public input is a Poseidon2-Fr statement hash
     binding every instance value the transcript consumed.

The builder emits constraints and witness in one pass from a concrete
proof; the layout depends only on the shape, so one setup serves every
proof of that shape.  Constraints, witness and public input equal the JAX
package's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..ops import goldilocks as gl
from ..ops import poseidon_fr as pfr
from .air import Air, Boundary
from . import air_wrap
from .r1cs_builder import Builder, FrVal, GLVal

FR = pfr.R
P_BOUND = gl.P - 1


# ---------------------------------------------------------------------------
# the algebra backend: AIR constraint families over lazy-GL wires


class R1CSAlg:
    """models/air.py constraint-algebra backend #3: values are GLVal
    wires (scalars) or python lists of them (stacked families)."""

    batched = False

    def __init__(self, b: Builder):
        self.b = b

    def c(self, v: int) -> GLVal:
        return self.b.gl_const(v)

    def full(self, v: int) -> GLVal:
        return self.b.gl_const(v)

    def _map2(self, f, a, b):
        la, lb = isinstance(a, list), isinstance(b, list)
        if la and lb:
            assert len(a) == len(b)
            return [f(x, y) for x, y in zip(a, b)]
        if la:
            return [f(x, b) for x in a]
        if lb:
            return [f(a, y) for y in b]
        return f(a, b)

    def add(self, a, b):
        return self._map2(self.b.gl_add, a, b)

    def sub(self, a, b):
        return self._map2(self.b.gl_sub, a, b)

    def mul(self, a, b):
        return self._map2(self.b.gl_mul, a, b)

    def stack(self, parts):
        out = []
        for p in parts:
            assert not isinstance(p, list)
            out.append(p)
        return out

    def concat0(self, parts):
        out = []
        for p in parts:
            out.extend(p if isinstance(p, list) else [p])
        return out

    def zeros(self, k):
        return [self.b.gl_const(0) for _ in range(k)]

    def get0(self, x, i):
        return x[i]

    def slice0(self, x, a, b):
        return x[a:b]

    def sum0(self, x):
        acc = x[0]
        for v in x[1:]:
            acc = self.b.gl_add(acc, v)
        return acc

    def const_matrix(self, rows):
        arr = np.asarray(rows, dtype=np.uint64)
        return arr

    def scale_rows(self, vec, x):
        return [self.b.gl_scale(x, int(c)) for c in np.atleast_1d(vec)]

    def matvec(self, mat, x):
        out = []
        for i in range(mat.shape[0]):
            acc = self.b.gl_const(0)
            for j, v in enumerate(x):
                acc = self.b.gl_add(acc, self.b.gl_scale(v, int(mat[i][j])))
            out.append(acc)
        return out


# ---------------------------------------------------------------------------
# transcript gadget (mirrors models/transcript_fr.py exactly)


class TranscriptGadget:
    def __init__(self, b: Builder, domain: str):
        self.b = b
        self.state = [b.const_fr(0)] * pfr.WIDTH
        self.pos = 0
        self._absorb_one(b.const_fr(pfr._sha_to_fr("ezt-transcript-fr/" + domain)))

    def _permute(self):
        self.state = self.b.poseidon_fr_perm(self.state)
        self.pos = 0

    def _absorb_one(self, v: FrVal):
        if self.pos == pfr.RATE:
            self._permute()
        self.state[self.pos] = self.b.fr_add(self.state[self.pos], v)
        self.pos += 1

    def absorb(self, label: str, values: List[FrVal]):
        self._absorb_one(
            self.b.const_fr(pfr._sha_to_fr("ezt-absorb-fr/" + label))
        )
        for v in values:
            self._absorb_one(v)

    def challenge_fr(self, label: str) -> FrVal:
        self._absorb_one(
            self.b.const_fr(pfr._sha_to_fr("ezt-challenge-fr/" + label))
        )
        self._permute()
        self.pos = 1
        return self.state[0]

    def challenge_bits(self, label: str) -> List[FrVal]:
        """Canonical bit decomposition of one squeeze (LSB first)."""
        return self.b.bits_canonical_fr(self.challenge_fr(label))


def _bits_to_gl(b: Builder, bits: List[FrVal]) -> GLVal:
    acc: Dict[int, int] = {}
    value = 0
    from .r1cs_builder import _expr_add, _expr_scale

    for i, bit in enumerate(bits):
        acc = _expr_add(acc, _expr_scale(bit.expr, 1 << i))
        value |= bit.value << i
    return GLVal(expr=acc, value=value, bound=(1 << len(bits)) - 1)


# ---------------------------------------------------------------------------
# statement hash (host helper shared with the settlement verifier)


def statement_tag(
    air: Air, shift: int, num_queries: int, boundaries, grind_bits: int = 0, *, device
) -> str:
    """The statement's domain tag; `device` commits the constants tree."""
    c_root = air_wrap.constants_root(air, shift, device)
    bpos = ",".join(f"{b.col}:{b.row}" for b in boundaries)
    grind = f"/g{grind_bits}" if grind_bits else ""
    return (
        f"wrap-stmt/{air.name}/{air.n}/{air.n_cols}/{air.ext_blowup}/"
        f"{shift}/{num_queries}/{c_root}/{bpos}{grind}"
    )


def statement_hash(
    air: Air, publics: List[int], boundaries, shift: int, num_queries: int,
    grind_bits: int = 0, *, device,
) -> int:
    """The single Groth16 public input: binds instance values under a
    shape-derived domain tag (including the wrap's own soundness
    parameters — query count and grind bits).  Anyone can recompute it
    from the claimed statement without seeing the proof."""
    tag = statement_tag(air, shift, num_queries, boundaries, grind_bits, device=device)
    elems = [int(v) % gl.P for v in publics] + [
        int(b.value) % gl.P for b in boundaries
    ]
    return pfr.hash_elements_host(elems, tag=tag)


# ---------------------------------------------------------------------------
# the circuit


def build_wrap_verifier(
    air: Air,
    proof: dict,
    publics: List[int],
    boundaries: List[Boundary],
    *,
    device,
) -> tuple:
    """Build the R1CS verifying `proof` (a prove_wrap output) and its
    witness.  Returns (r1cs, witness, public_input); `device` commits the
    AIR's constants tree.

    Raises AssertionError while building if the proof is invalid — the
    same proofs verify_wrap rejects produce unsatisfiable wire values, so
    no Groth16 proof can be produced for them."""
    b = Builder()
    pub_value = statement_hash(
        air, publics, boundaries, int(proof["shift"]),
        int(proof["num_queries"]), int(proof.get("grind_bits", 0)), device=device,
    )
    pub = b.witness_fr(pub_value)  # var 1: THE public input
    stmt = add_wrap_verifier(b, air, proof, publics, boundaries, device=device)
    b.fr_assert_eq(stmt, pub)
    r1cs, witness = b.finalize([1])
    return r1cs, witness, pub_value


def final_public_input(stmt_hashes: List[int], aggregator_addr: str) -> int:
    """The FinalProof public input: one Fr element binding every child
    attestation statement and the aggregator address.  Recomputable by
    the settlement verifier from the claimed headers alone."""
    return pfr.hash_elements_host(
        [int(h) % FR for h in stmt_hashes],
        tag=f"final-stmt/{len(stmt_hashes)}/{aggregator_addr}",
    )


def build_final_circuit(entries: List[tuple], aggregator_addr: str, *, device) -> tuple:
    """The FinalProof circuit: verify EVERY child wrap attestation
    in-circuit and bind their statement hashes (+ the aggregator address)
    into the single Groth16 public input.

    entries: [(air, wrap_proof, publics, boundaries), ...]; `device`
    commits the AIRs' constants trees.  Returns (r1cs, witness,
    public_input)."""
    b = Builder()
    stmt_values = [
        statement_hash(
            air, publics, bnds, int(proof["shift"]),
            int(proof["num_queries"]), int(proof.get("grind_bits", 0)), device=device,
        )
        for air, proof, publics, bnds in entries
    ]
    pub_value = final_public_input(stmt_values, aggregator_addr)
    pub = b.witness_fr(pub_value)  # var 1
    stmts = [
        add_wrap_verifier(b, air, proof, publics, bnds, device=device)
        for air, proof, publics, bnds in entries
    ]
    bound = b.poseidon_fr_sponge(
        stmts, tag=f"final-stmt/{len(stmts)}/{aggregator_addr}"
    )
    b.fr_assert_eq(bound, pub)
    r1cs, witness = b.finalize([1])
    return r1cs, witness, pub_value


def add_wrap_verifier(
    b: Builder,
    air: Air,
    proof: dict,
    publics: List[int],
    boundaries: List[Boundary],
    *,
    device,
) -> FrVal:
    """Emit the full wrap-STARK verification into `b`; returns the
    statement-hash wire binding this proof's instance."""
    n = air.n
    C = air.n_cols
    B = air.ext_blowup
    m = n * B
    shift = int(proof["shift"])
    num_queries = int(proof["num_queries"])
    grind_bits = int(proof.get("grind_bits", 0))
    params = air.fri_params(num_queries, grind_bits)
    K = len(air.periodic)
    assert int(proof["n"]) == n and int(proof["n_cols"]) == C
    assert int(proof["ext_blowup"]) == B
    assert int(proof["fri"]["domain_size"]) == m
    c_root_const = air_wrap.constants_root(air, shift, device)
    assert int(proof["const_root"]) == c_root_const
    assert len(proof["trace_openings"]) == num_queries
    assert len(proof["const_openings"]) == num_queries
    assert len(proof["fri"]["queries"]) == num_queries

    # --- instance wires -------------------------------------------------------
    pub_wires = [b.witness_fr(int(v) % gl.P) for v in publics]
    bval_wires = [b.witness_fr(int(bd.value) % gl.P) for bd in boundaries]
    for w in pub_wires + bval_wires:
        b.bits_of(w, 64)  # GL range
    root_wire = b.witness_fr(int(proof["trace_root"]))

    # the statement wire this proof's instance hashes to
    stmt = b.poseidon_fr_sponge(
        pub_wires + bval_wires,
        tag=statement_tag(air, shift, num_queries, boundaries, grind_bits, device=device),
    )

    # --- transcript replay ----------------------------------------------------
    t = TranscriptGadget(b, f"ezt-air-wrap/{air.name}")
    t.absorb("public", [b.const_fr(len(publics))] + pub_wires)
    b_flat = []
    for bd, w in zip(boundaries, bval_wires):
        b_flat += [b.const_fr(bd.col), b.const_fr(bd.row), w]
    t.absorb("boundary", b_flat)
    t.absorb("const-root", [b.const_fr(c_root_const)])
    t.absorb("trace-root", [root_wire])
    alpha_bits = t.challenge_bits("alpha")
    alpha = _bits_to_gl(b, alpha_bits[:63])
    n_con_alphas = sum(c.arity for c in air.constraints)
    n_alphas = n_con_alphas + len(boundaries)
    alphas: List[GLVal] = []
    acc = b.gl_const(1)
    for _ in range(n_alphas):
        acc = b.gl_mul(acc, alpha)
        alphas.append(acc)

    # --- FRI roots / betas / terminal coefficients ----------------------------
    sizes, shifts = [], []
    size, cur_shift = m, shift
    roots_w: List[FrVal] = []
    betas: List[GLVal] = []
    fri = proof["fri"]
    for r in fri["roots"]:
        assert size > params.terminal_size, "too many FRI layers"
        rw = b.witness_fr(int(r))
        roots_w.append(rw)
        t.absorb("fri-root", [rw])
        betas.append(_bits_to_gl(b, t.challenge_bits(f"fri-beta")[:63]))
        sizes.append(size)
        shifts.append(cur_shift)
        size //= 2
        cur_shift = gl.h_mul(cur_shift, cur_shift)
    assert size <= params.terminal_size, "not enough FRI layers"
    R_layers = len(sizes)
    final_coeffs = [int(c) % gl.P for c in fri["final_coeffs"]]
    assert len(final_coeffs) == size // params.blowup
    coeff_packed = [
        b.witness_fr(v) for v in pfr.pack_gl_host(final_coeffs)
    ]
    t.absorb("fri-final", coeff_packed)
    coeff_gl: List[GLVal] = []
    for i, pw in enumerate(coeff_packed):
        kk = min(pfr.GL_PACK, len(final_coeffs) - i * pfr.GL_PACK)
        coeff_gl.extend(b.unpack_gl(pw, kk))

    if params.grind_bits:
        # proof-of-work gadget: replay the grind absorb/challenge and
        # constrain the low grind_bits of the (already canonically
        # decomposed) challenge to zero — ~1 permutation + 1
        # decomposition, the cheapest conjectured bits in the circuit
        nonce_w = b.witness_fr(int(fri["grind_nonce"]))
        t.absorb("grind", [nonce_w])
        gbits = t.challenge_bits("grind-ok")
        zero = b.const_fr(0)
        for i in range(params.grind_bits):
            b.fr_assert_eq(gbits[i], zero)

    d_bits = (m // 2).bit_length() - 1  # query index bits
    idx_bits_per_q = [
        t.challenge_bits(f"fri-query/{q}")[:d_bits] for q in range(num_queries)
    ]

    # --- static constants ------------------------------------------------------
    w_m = gl.primitive_root_of_unity(m)
    w_n = gl.primitive_root_of_unity(n)
    w_last = gl.h_pow(w_n, n - 1)
    alg = R1CSAlg(b)
    from .r1cs_builder import _expr_add, _expr_scale

    def bits_value(bits: List[FrVal]) -> int:
        return sum(bit.value << i for i, bit in enumerate(bits))

    def open_packed_row(
        row_ints: List[int], dir_bits: List[FrVal], path_ints: List[int], root: FrVal,
        n_values: int,
    ) -> List[GLVal]:
        """Witness a packed leaf row + path, Merkle-check it, return the
        unpacked (range-proven) GL values."""
        packed_host = pfr.pack_gl_host([int(v) for v in row_ints])
        packed_w = [b.witness_fr(v) for v in packed_host]
        vals: List[GLVal] = []
        for i, pw in enumerate(packed_w):
            kk = min(pfr.GL_PACK, n_values - i * pfr.GL_PACK)
            vals.extend(b.unpack_gl(pw, kk))
        digest = b.poseidon_fr_sponge(packed_w, tag="leaf")
        path_w = [b.witness_fr(int(p)) for p in path_ints]
        b.merkle_check(digest, dir_bits, path_w, root)
        return vals

    def composition_at(x: GLVal, x_pow_n: GLVal, cur_vals, nxt_vals, per_vals) -> GLVal:
        zh = b.gl_sub(x_pow_n, b.gl_const(1))
        zh_inv = b.gl_inv(zh)
        last_fac = b.gl_sub(x, b.gl_const(w_last))
        comp_t = b.gl_const(0)  # transition-domain sum
        comp_a = b.gl_const(0)  # all-domain sum
        off = 0
        for c in air.constraints:
            v = c.fn(alg, cur_vals, nxt_vals, per_vals)
            vals = v if isinstance(v, list) else [v]
            assert len(vals) == c.arity, f"{c.name}: arity mismatch"
            for i, vi in enumerate(vals):
                term = b.gl_mul(alphas[off + i], vi)
                if c.domain == "transition":
                    comp_t = b.gl_add(comp_t, term)
                else:
                    comp_a = b.gl_add(comp_a, term)
            off += c.arity
        comp = b.gl_add(b.gl_mul(comp_t, last_fac), comp_a)
        comp = b.gl_mul(comp, zh_inv)
        for j, bd in enumerate(boundaries):
            den = b.gl_sub(x, b.gl_const(gl.h_pow(w_n, bd.row)))
            den_inv = b.gl_inv(den)
            bw = bval_wires[j]
            diff = b.gl_sub(
                cur_vals[bd.col],
                GLVal(expr=dict(bw.expr), value=bw.value, bound=(1 << 64) - 1),
            )
            q = b.gl_mul(diff, den_inv)
            comp = b.gl_add(comp, b.gl_mul(alphas[n_con_alphas + j], q))
        return comp

    def terminal_eval(x: GLVal) -> GLVal:
        val = b.gl_const(0)
        for c in reversed(coeff_gl):
            val = b.gl_add(b.gl_mul(val, x), c)
        return val

    # --- per query --------------------------------------------------------------
    for q in range(num_queries):
        jbits = idx_bits_per_q[q]
        jj = bits_value(jbits)
        t_open = proof["trace_openings"][q]
        c_open = proof["const_openings"][q]
        fri_q = fri["queries"][q]
        assert int(fri_q["index"]) == jj, "witness proof disagrees with replay"
        assert len(fri_q["layers"]) == R_layers

        zero_bit = b.const_fr(0)
        one_bit = b.const_fr(1)
        expect = [jj, (jj + B) % m, jj + m // 2, (jj + m // 2 + B) % m]
        # direction-bit lists for the 4 trace openings
        bits0 = jbits + [zero_bit]
        bits2 = jbits + [one_bit]

        def offset_bits(base_bits: List[FrVal], target: int, delta: int):
            """Witness bits of (value(base)+delta) mod m, constrained by
            the linear identity recompose == base + delta - carry*m."""
            tbits = [b.fr_bool((target >> i) & 1) for i in range(m.bit_length() - 1)]
            carry = b.fr_bool(1 if bits_value(base_bits) + delta >= m else 0)
            acc: Dict[int, int] = {}
            for i, bit in enumerate(tbits):
                acc = _expr_add(acc, _expr_scale(bit.expr, 1 << i))
            base_acc: Dict[int, int] = {}
            for i, bit in enumerate(base_bits):
                base_acc = _expr_add(base_acc, _expr_scale(bit.expr, 1 << i))
            lhs = _expr_add(acc, _expr_scale(base_acc, -1))
            lhs = _expr_add(lhs, {0: -delta})
            lhs = _expr_add(lhs, _expr_scale(carry.expr, m))
            b.emit(lhs, {0: 1}, {})
            return tbits

        bits1 = offset_bits(bits0, expect[1], B)
        bits3 = offset_bits(bits0, expect[3], m // 2 + B)

        rows_gl = []
        for entry, want_i, dbits in zip(
            t_open, expect, (bits0, bits1, bits2, bits3)
        ):
            assert int(entry["index"]) == want_i
            row = [int(x) for x in entry["row"]]
            assert len(row) == C
            rows_gl.append(
                open_packed_row(
                    row, dbits, [int(x) for x in entry["path"]], root_wire, C
                )
            )

        per_gl = []
        c_root_w = b.const_fr(c_root_const)
        for entry, want_i, dbits in zip(c_open, (jj, jj + m // 2), (bits0, bits2)):
            assert int(entry["index"]) == want_i
            row = [int(x) for x in entry["row"]]
            assert len(row) == K
            per_gl.append(
                open_packed_row(
                    row, dbits, [int(x) for x in entry["path"]], c_root_w, K
                )
            )

        def point_ladder(sh: int, w: int, bits: List[FrVal]) -> GLVal:
            """sh * w^(value(bits)) — one constrained multiply per bit."""
            x = b.gl_const(sh)
            for i, bit in enumerate(bits):
                wk = gl.h_pow(w, 1 << i)
                fac = GLVal(
                    expr=_expr_add({0: 1}, _expr_scale(bit.expr, wk - 1)),
                    value=1 + bit.value * (wk - 1),
                    bound=wk,
                )
                x = b.gl_mul(x, fac)
            return b.gl_reduce(x)

        # x_u = shift * w_m^jj; x_v = -x_u
        x_u = point_ladder(shift, w_m, jbits)
        x_v = b.gl_sub(b.gl_const(0), x_u)
        xn = x_u
        for _ in range(n.bit_length() - 1):
            xn = b.gl_mul(xn, xn)  # x^n (n a power of two)
        xn_u = xn
        # (-x)^n = x^n for even n (n >= 2 is a power of two)
        assert n >= 2
        xn_v = xn_u

        comp_u = composition_at(x_u, xn_u, rows_gl[0], rows_gl[1], per_gl[0])
        comp_v = composition_at(x_v, xn_v, rows_gl[2], rows_gl[3], per_gl[1])

        if R_layers == 0:
            b.gl_assert_eq(comp_u, terminal_eval(x_u))
            b.gl_assert_eq(comp_v, terminal_eval(x_v))
            continue

        # FRI fold layers.  Each layer's evaluation point is laddered from
        # its OWN index bits — chaining x_{l+1} = x_l^2 alone would be off
        # by the (-1)^topbit the pair-index truncation introduces (the
        # same sign the recursion AIR tracks in its ftb register,
        # models/recursion.py fxchain).
        u_prev = v_prev = x_prev = None
        kept_bits = list(jbits)
        for li, layer in enumerate(fri_q["layers"]):
            # layer-l pair index jj_l = low log2(sizes[l]/2) bits of jbits
            half_bits = (sizes[li] // 2).bit_length() - 1
            pbits = kept_bits[:half_bits]
            row = [int(layer["u"]), int(layer["v"])]
            uv = open_packed_row(
                row,
                pbits,
                [int(x_) for x_ in layer["path"]],
                roots_w[li],
                2,
            )
            u_l, v_l = uv
            x_l = point_ladder(
                shifts[li], gl.primitive_root_of_unity(sizes[li]), pbits
            )
            if li == 0:
                b.gl_assert_eq(comp_u, u_l)
                b.gl_assert_eq(comp_v, v_l)
            else:
                top = kept_bits[half_bits] if len(kept_bits) > half_bits else None
                assert top is not None
                sel = b.fr_select(
                    top,
                    b.gl_to_fr(v_l),
                    b.gl_to_fr(u_l),
                )
                got = GLVal(expr=dict(sel.expr), value=sel.value, bound=P_BOUND)
                # 2*x_{l-1}*got == x_{l-1}(u_{l-1}+v_{l-1}) + beta(u_{l-1}-v_{l-1})
                lhs = b.gl_mul(b.gl_scale(x_prev, 2), got)
                rhs = b.gl_add(
                    b.gl_mul(x_prev, b.gl_add(u_prev, v_prev)),
                    b.gl_mul(betas[li - 1], b.gl_sub(u_prev, v_prev)),
                )
                b.gl_assert_eq(lhs, rhs)
            u_prev, v_prev = u_l, v_l
            x_prev = x_l
            kept_bits = kept_bits[:half_bits]
        # terminal check against the final polynomial at the folded point
        t_size = sizes[-1] // 2
        t_shift = gl.h_mul(shifts[-1], shifts[-1])
        x_term = point_ladder(
            t_shift, gl.primitive_root_of_unity(t_size), kept_bits
        )
        val = terminal_eval(x_term)
        lhs = b.gl_mul(b.gl_scale(x_prev, 2), val)
        rhs = b.gl_add(
            b.gl_mul(x_prev, b.gl_add(u_prev, v_prev)),
            b.gl_mul(betas[R_layers - 1], b.gl_sub(u_prev, v_prev)),
        )
        b.gl_assert_eq(lhs, rhs)

    return stmt
