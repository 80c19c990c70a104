"""R1CS circuit builder — port of eigen_zeth_tpu/models/r1cs_builder.py.

Gadgets for verifying the wrap-profile STARK (models/air_wrap.py) inside
the Groth16 final proof.  Each gadget emits R1CS rows and computes the
concrete wire values in one pass; the constraint structure depends only on
static shape parameters, never on witness values, so a circuit built from
any valid proof of a shape serves as the setup circuit of every proof of
that shape.  The constraints, the witness and their order are the JAX
package's, row for row.

Two value domains:

  * FrVal — native BN254-Fr wires: linear combinations are free, a
    multiply is one constraint; a Poseidon2-Fr permutation costs ~492
    constraints (the S-box multiplies; the matrices fold into the rows).
  * GLVal — a Goldilocks value embedded in Fr as a linear expression with a
    bound on its magnitude.  Arithmetic is lazy: adds track bounds,
    multiplies emit one constraint, and a reduction witness (quotient and
    64-bit remainder decomposition) pins the value mod p only when a bound
    would overflow Fr or the protocol compares values.  Opened leaf values
    enter through the 64-bit unpack decomposition, which is their range
    proof.

Soundness of laziness: every GLVal keeps |value| <= bound < R/2, so mod-R
arithmetic on the wires is integer arithmetic, and the final reduction's
identity e + Q0*p = q'*p + r (q' range-checked, r < 2^64) fixes e mod p.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ..ops import goldilocks as gl
from ..ops import poseidon_fr as pfr
from .groth16 import R1CS

FR = pfr.R
P = gl.P
HALF_FR = FR // 2


# An expression maps var -> coefficient.  The constant term (var 0) is kept
# as the exact integer the JAX package's builder carries, because its
# constant test `expr == {0: value}` compares that integer with the reduced
# value; every other coefficient is kept reduced mod FR, which emits the
# same rows (rows are reduced mod FR) without the integers growing by 254
# bits with every multiply by a Poseidon constant.


def _expr_add(a: Dict[int, int], b: Dict[int, int]) -> Dict[int, int]:
    out = dict(a)
    for v, c in b.items():
        nc = out.get(v, 0) + c
        if v:
            nc %= FR
        if nc:
            out[v] = nc
        else:
            out.pop(v, None)
    return out


def _expr_scale(a: Dict[int, int], k: int) -> Dict[int, int]:
    if k == 0:
        return {}
    out = {v: c * k % FR for v, c in a.items() if v}
    if 0 in a:
        out[0] = a[0] * k
    return out


@functools.lru_cache(maxsize=1)
def _external_matrix() -> list:
    """M_E as a 12 x 12 matrix of small integers (its columns are M_E
    applied to the unit vectors)."""
    cols = [pfr._external_host([int(i == j) for i in range(pfr.WIDTH)]) for j in range(pfr.WIDTH)]
    return [[cols[j][i] for j in range(pfr.WIDTH)] for i in range(pfr.WIDTH)]


def _partial_tables(s: List["FrVal"]) -> tuple:
    """For lanes s entering the partial rounds: (the variable of each column,
    column 0 the constant; X, row k the lanes' part of S-box k's input; F,
    row i the lanes' part of lane i leaving), as lists of ints mod FR."""
    delta, _, _, Z, _ = _partial_coeffs()
    cols, index = [0], {0: 0}
    for x in s:
        for v in x.expr:
            if v not in index:
                index[v] = len(cols)
                cols.append(v)
    L0 = np.zeros((pfr.WIDTH, len(cols)), dtype=object)
    for i, x in enumerate(s):
        for v, c in x.expr.items():
            L0[i, index[v]] = c % FR
    X = np.concatenate([L0[:1], np.dot(delta, L0[1:]) % FR])
    F = np.dot(Z, L0[1:]) % FR
    return cols, X.tolist(), F.tolist()


@functools.lru_cache(maxsize=1)
def _partial_tables_me() -> tuple:
    """`_partial_tables` for lanes that are M_E over twelve fresh variables
    (columns: the constant, then those variables in order): X and F."""
    me = _external_matrix()
    L0 = np.array([[0] + row for row in me], dtype=object)
    delta, _, _, Z, _ = _partial_coeffs()
    X = np.concatenate([L0[:1], np.dot(delta, L0[1:]) % FR])
    return X.tolist(), (np.dot(Z, L0[1:]) % FR).tolist()


def _me_vars(s: List["FrVal"]):
    """The twelve variables w if lane i of s is {w_j: M_E[i][j]}, else None."""
    first = list(s[0].expr)
    if len(first) != pfr.WIDTH or 0 in s[0].expr:
        return None
    me = _external_matrix()
    for i, x in enumerate(s):
        if x.expr != dict(zip(first, me[i])):
            return None
    return first


def _external_vars(outs: List["FrVal"]) -> List["FrVal"]:
    """M_E applied to twelve fresh variables: lane i is {w_j: M_E[i][j]}."""
    me = _external_matrix()
    ws = [next(iter(o.expr)) for o in outs]
    vals = pfr._external_host([o.value for o in outs])
    return [FrVal(expr=dict(zip(ws, me[i])), value=vals[i]) for i in range(pfr.WIDTH)]


@functools.lru_cache(maxsize=1)
def _partial_coeffs():
    """The closed form of Poseidon2-Fr's partial rounds over lane vectors.

    With L_i the lanes entering the K partial rounds, w_t S-box t's output,
    T_t = w_t + sum_{i>=1} lane_i after S-box t (the internal layer's total)
    and P_j = sum_{i>=1} mu_i^j:
      lane_i (i >= 1) after round k = mu_i^k L_i + sum_{t<k} mu_i^(k-1-t) T_t,
      lane_0 after round k = T_(k-1) + mu_0 w_(k-1),
      T_k = w_k + sum_{i>=1} delta[k][i] L_i + sum_{j<=k} gamma[k-j] w_j,
    with gamma[0] = 1, gamma[d] = sum_{t<d} P_(d-1-t) gamma[t] and
    delta[k][i] = mu_i^k + sum_{t<k} P_(k-1-t) delta[t][i].  Returns delta
    ((K-1) x 11, the S-box inputs' lane part), gamma, mu, and Z (12 x 11),
    E (12 x K): the lanes after the last round over the L_i (i >= 1) and the
    w_j.  Everything mod FR."""
    mu = pfr.internal_diag()
    K = pfr.PARTIAL_ROUNDS
    P = [sum(pow(m, j, FR) for m in mu[1:]) % FR for j in range(K)]
    gamma = [1]
    for d in range(1, K):
        gamma.append(sum(P[d - 1 - t] * gamma[t] for t in range(d)) % FR)
    delta = []
    for k in range(K):
        delta.append([(pow(m, k, FR) + sum(P[k - 1 - t] * delta[t][i] for t in range(k))) % FR
                      for i, m in enumerate(mu[1:])])
    Z = [list(delta[K - 1])]
    E = [[(gamma[K - 1 - j] + (mu[0] if j == K - 1 else 0)) % FR for j in range(K)]]
    for i, m in enumerate(mu[1:]):
        z = [sum(pow(m, K - 1 - t, FR) * delta[t][i2] for t in range(K)) % FR
             for i2 in range(len(mu) - 1)]
        z[i] = (z[i] + pow(m, K, FR)) % FR
        Z.append(z)
        E.append([sum(pow(m, K - 1 - t, FR) * gamma[t - j] for t in range(j, K)) % FR
                  for j in range(K)])
    arr = lambda rows: np.array(rows, dtype=object)  # noqa: E731
    return arr(delta[: K - 1]), gamma, mu, arr(Z), E


@dataclass
class FrVal:
    expr: Dict[int, int]  # var -> integer coeff (reduced mod FR at emit)
    value: int  # canonical Fr value


@dataclass
class GLVal:
    expr: Dict[int, int]
    value: int  # exact signed integer under the canonical witness
    bound: int  # |value| <= bound < FR/2


class Builder:
    """Emits R1CS constraints and the matching witness in one pass."""

    def __init__(self):
        self.witness: List[int] = [1]
        self.constraints: List[tuple] = []
        self.num_public = 0  # set by finalize / make_public

    # -- core ----------------------------------------------------------------

    def new_var(self, value: int) -> int:
        self.witness.append(int(value) % FR)
        return len(self.witness) - 1

    def _row(self, expr: Dict[int, int]) -> Dict[int, int]:
        return {v: r for v, c in expr.items() if (r := c % FR)}

    def emit(self, a: Dict[int, int], b: Dict[int, int], c: Dict[int, int]):
        self.constraints.append((self._row(a), self._row(b), self._row(c)))

    def const_fr(self, v: int) -> FrVal:
        v = int(v) % FR
        return FrVal(expr={0: v} if v else {}, value=v)

    def witness_fr(self, value: int) -> FrVal:
        var = self.new_var(value)
        return FrVal(expr={var: 1}, value=int(value) % FR)

    # -- native Fr arithmetic --------------------------------------------------

    def fr_add(self, a: FrVal, b: FrVal) -> FrVal:
        return FrVal(_expr_add(a.expr, b.expr), (a.value + b.value) % FR)

    def fr_sub(self, a: FrVal, b: FrVal) -> FrVal:
        return FrVal(
            _expr_add(a.expr, _expr_scale(b.expr, -1)), (a.value - b.value) % FR
        )

    def fr_scale(self, a: FrVal, k: int) -> FrVal:
        return FrVal(_expr_scale(a.expr, int(k) % FR), a.value * int(k) % FR)

    def fr_mul(self, a: FrVal, b: FrVal) -> FrVal:
        if not a.expr or a.expr == {0: a.value}:  # constant
            return self.fr_scale(b, a.value)
        if not b.expr or b.expr == {0: b.value}:
            return self.fr_scale(a, b.value)
        w = self.new_var(a.value * b.value % FR)
        self.emit(a.expr, b.expr, {w: 1})
        return FrVal(expr={w: 1}, value=a.value * b.value % FR)

    def fr_assert_eq(self, a: FrVal, b: FrVal):
        assert a.value == b.value, "witness violates Fr equality"
        self.emit(_expr_add(a.expr, _expr_scale(b.expr, -1)), {0: 1}, {})

    def fr_bool(self, value: int) -> FrVal:
        """A witness bit with b·b = b (the three rows are one dict: equal
        rows, shared)."""
        assert value in (0, 1)
        var = self.new_var(value)
        row = {var: 1}
        self.constraints.append((row, row, row))
        return FrVal(expr={var: 1}, value=value)

    def _bits(self, x: FrVal, n_bits: int) -> List[FrVal]:
        """Witness bits b_i of x with b_i·b_i = b_i and x == sum b_i 2^i
        (the recomposition row is {b_i: 2^i} minus x, built at once)."""
        bits = [self.fr_bool((x.value >> i) & 1) for i in range(n_bits)]
        acc = {next(iter(b.expr)): 1 << i for i, b in enumerate(bits)}
        self.emit(_expr_add(acc, _expr_scale(x.expr, -1)), {0: 1}, {})
        return bits

    def fr_select(self, bit: FrVal, a: FrVal, b: FrVal) -> FrVal:
        """bit ? a : b  —  b + bit·(a-b), one constraint."""
        return self.fr_add(b, self.fr_mul(bit, self.fr_sub(a, b)))

    # -- decompositions --------------------------------------------------------

    def bits_of(self, x: FrVal, n_bits: int) -> List[FrVal]:
        """x == sum b_i 2^i with b_i boolean; REQUIRES x.value < 2^n_bits
        and 2^n_bits <= FR (unique decomposition)."""
        assert 0 <= x.value < (1 << n_bits) <= FR
        return self._bits(x, n_bits)

    def bits_canonical_fr(self, x: FrVal) -> List[FrVal]:
        """Full 254-bit decomposition of a native Fr wire with a
        strict-less-than-R check, so the decomposition is UNIQUE (without
        it a prover could present x or x+R and pick between two derived
        challenges)."""
        assert 0 <= x.value < FR
        bits = self._bits(x, 254)
        self._assert_bits_lt_const(bits, FR)
        return bits

    def _assert_bits_lt_const(self, bits: List[FrVal], K: int):
        """sum b_i 2^i < K (MSB scan: eq-prefix chain)."""
        n = len(bits)
        eq = self.const_fr(1)  # prefix of x equals prefix of K so far
        lt = self.const_fr(0)
        for i in range(n - 1, -1, -1):
            k_i = (K >> i) & 1
            b = bits[i]
            if k_i:
                # x_i = 0 while equal so far -> strictly less
                lt = self.fr_add(lt, self.fr_mul(eq, self.fr_sub(self.const_fr(1), b)))
                eq = self.fr_mul(eq, b)
            else:
                eq = self.fr_mul(eq, self.fr_sub(self.const_fr(1), b))
        # strict: a full equal prefix means x == K, which is not allowed
        self.fr_assert_eq(lt, self.const_fr(1))

    # -- Goldilocks-in-Fr (lazy) ----------------------------------------------

    def gl_const(self, v: int) -> GLVal:
        v = int(v) % P
        return GLVal(expr={0: v} if v else {}, value=v, bound=v)

    def gl_from_bits64(self, x: FrVal) -> GLVal:
        """Range-proven 64-bit value (the opened-leaf entry point)."""
        self.bits_of(x, 64)
        return GLVal(expr=dict(x.expr), value=x.value, bound=(1 << 64) - 1)

    def gl_add(self, a: GLVal, b: GLVal) -> GLVal:
        v = GLVal(_expr_add(a.expr, b.expr), a.value + b.value, a.bound + b.bound)
        return self._maybe_reduce(v)

    def gl_sub(self, a: GLVal, b: GLVal) -> GLVal:
        v = GLVal(
            _expr_add(a.expr, _expr_scale(b.expr, -1)),
            a.value - b.value,
            a.bound + b.bound,
        )
        return self._maybe_reduce(v)

    def gl_scale(self, a: GLVal, k: int) -> GLVal:
        k = int(k) % P
        return self._maybe_reduce(
            GLVal(_expr_scale(a.expr, k), a.value * k, a.bound * k)
        )

    def gl_mul(self, a: GLVal, b: GLVal) -> GLVal:
        if not a.expr or list(a.expr) == [0]:
            return self.gl_scale(b, a.value % P)
        if not b.expr or list(b.expr) == [0]:
            return self.gl_scale(a, b.value % P)
        if a.bound * b.bound >= HALF_FR:
            if a.bound > b.bound:
                a = self.gl_reduce(a)
            else:
                b = self.gl_reduce(b)
            if a.bound * b.bound >= HALF_FR:
                a = self.gl_reduce(a)
                b = self.gl_reduce(b)
        w = self.new_var(a.value * b.value)
        self.emit(a.expr, b.expr, {w: 1})
        return GLVal(expr={w: 1}, value=a.value * b.value, bound=a.bound * b.bound)

    def _maybe_reduce(self, v: GLVal) -> GLVal:
        return self.gl_reduce(v) if v.bound >= HALF_FR else v

    def gl_reduce(self, a: GLVal) -> GLVal:
        """Canonical remainder r = a mod p with the integer identity
        a + Q0·p = q'·p + r,  q' in [0, 2·Q0], r in [0, 2^64)."""
        if a.bound < P and a.value >= 0:
            return a
        r = a.value % P
        q = (a.value - r) // P
        q0 = a.bound // P + 1
        q_shift = q + q0
        assert 0 <= q_shift <= 2 * q0
        qbits = max(1, (2 * q0).bit_length())
        r_fr = self.witness_fr(r)
        self.bits_of(r_fr, 64)
        q_fr = self.witness_fr(q_shift)
        self.bits_of(q_fr, qbits)
        # a + q0·p - q'·p - r == 0   (linear, integer identity fits Fr)
        lhs = _expr_add(a.expr, {0: q0 * P})
        lhs = _expr_add(lhs, _expr_scale(q_fr.expr, -P))
        lhs = _expr_add(lhs, _expr_scale(r_fr.expr, -1))
        self.emit(lhs, {0: 1}, {})
        return GLVal(expr=dict(r_fr.expr), value=r, bound=P - 1)

    def gl_assert_zero(self, a: GLVal):
        """a ≡ 0 (mod p)."""
        assert a.value % P == 0, "witness violates GL equality"
        q = a.value // P
        q0 = a.bound // P + 1
        q_shift = q + q0
        qbits = max(1, (2 * q0).bit_length())
        q_fr = self.witness_fr(q_shift)
        self.bits_of(q_fr, qbits)
        lhs = _expr_add(a.expr, {0: q0 * P})
        lhs = _expr_add(lhs, _expr_scale(q_fr.expr, -P))
        self.emit(lhs, {0: 1}, {})

    def gl_assert_eq(self, a: GLVal, b: GLVal):
        self.gl_assert_zero(
            GLVal(
                _expr_add(a.expr, _expr_scale(b.expr, -1)),
                a.value - b.value,
                a.bound + b.bound,
            )
        )

    def gl_inv(self, a: GLVal) -> GLVal:
        """Witness inverse: i·a ≡ 1 (mod p).  Nonzero by protocol."""
        av = a.value % P
        assert av != 0
        inv = gl.h_inv(av)
        i = GLVal(expr={self.new_var(inv): 1}, value=inv, bound=P - 1)
        prod = self.gl_mul(i, a)
        self.gl_assert_zero(
            GLVal(_expr_add(prod.expr, {0: -1}), prod.value - 1, prod.bound + 1)
        )
        return i

    def gl_to_fr(self, a: GLVal) -> FrVal:
        """A CANONICAL (reduced, non-negative) GL value as a native Fr wire."""
        a = self.gl_reduce(a)
        if a.value < 0:  # pragma: no cover - reduce returns canonical
            raise AssertionError
        return FrVal(expr=dict(a.expr), value=a.value % FR)

    # -- packing ----------------------------------------------------------------

    def unpack_gl(self, packed: FrVal, k: int) -> List[GLVal]:
        """One packed Fr wire -> k (<= 3) range-proven 64-bit GL values.
        The recomposition constraint IS the leaf range proof."""
        assert 1 <= k <= pfr.GL_PACK
        vals = []
        acc: Dict[int, int] = {}
        rem = packed.value
        for j in range(k):
            vj = rem & ((1 << 64) - 1)
            rem >>= 64
            fv = self.witness_fr(vj)
            self.bits_of(fv, 64)
            vals.append(GLVal(expr=dict(fv.expr), value=vj, bound=(1 << 64) - 1))
            acc = _expr_add(acc, _expr_scale(fv.expr, 1 << (64 * j)))
        assert rem == 0, "packed element exceeds k values"
        self.emit(_expr_add(acc, _expr_scale(packed.expr, -1)), {0: 1}, {})
        return vals

    def pack_gl(self, vals: List[GLVal]) -> FrVal:
        """Canonical GL values -> one packed Fr wire (linear)."""
        assert 1 <= len(vals) <= pfr.GL_PACK
        acc: Dict[int, int] = {}
        value = 0
        for j, v in enumerate(vals):
            v = self.gl_reduce(v)
            acc = _expr_add(acc, _expr_scale(v.expr, 1 << (64 * j)))
            value |= (v.value % P) << (64 * j)
        return FrVal(expr=acc, value=value % FR)

    # -- Poseidon2-Fr gadget ------------------------------------------------------

    def poseidon_fr_perm(self, state: List[FrVal]) -> List[FrVal]:
        assert len(state) == pfr.WIDTH
        rc = pfr.round_constants()
        mu = pfr.internal_diag()

        def sbox(x: FrVal) -> FrVal:
            x2 = self.fr_mul(x, x)
            x4 = self.fr_mul(x2, x2)
            return self.fr_mul(x4, x)

        def m4_block(x):
            t0 = self.fr_add(x[0], x[1])
            t1 = self.fr_add(x[2], x[3])
            t2 = self.fr_add(self.fr_scale(x[1], 2), t1)
            t3 = self.fr_add(self.fr_scale(x[3], 2), t0)
            t4 = self.fr_add(self.fr_scale(t1, 4), t3)
            t5 = self.fr_add(self.fr_scale(t0, 4), t2)
            return [self.fr_add(t3, t5), t5, self.fr_add(t2, t4), t4]

        def external(s):
            blocks = [m4_block(s[i : i + 4]) for i in range(0, pfr.WIDTH, 4)]
            sums = [
                self.fr_add(self.fr_add(blocks[0][j], blocks[1][j]), blocks[2][j])
                for j in range(4)
            ]
            return [
                self.fr_add(blocks[i // 4][i % 4], sums[i % 4])
                for i in range(pfr.WIDTH)
            ]

        def internal(s):
            tot = s[0]
            for i in range(1, pfr.WIDTH):
                tot = self.fr_add(tot, s[i])
            return [
                self.fr_add(tot, self.fr_scale(s[i], mu[i]))
                for i in range(pfr.WIDTH)
            ]

        def full_rounds(s, rounds):
            """The full rounds `rounds` from lanes s; the first S-box layer
            goes through the gadgets, and once its outputs are fresh
            variables the rest take their rows from M_E directly."""
            outs = [sbox(self.fr_add(v, self.const_fr(rc[rounds[0]][i]))) for i, v in enumerate(s)]
            if all(len(o.expr) == 1 and o.expr.get(next(iter(o.expr))) == 1 and 0 not in o.expr
                   for o in outs):
                outs = self._full_rounds_fast(outs, rounds[1:], rc)
                return _external_vars(outs)
            for r in rounds[1:]:
                s = external(outs)
                outs = [sbox(self.fr_add(v, self.const_fr(rc[r][i]))) for i, v in enumerate(s)]
            return external(outs)

        half = pfr.FULL_ROUNDS // 2
        partial = range(half, half + pfr.PARTIAL_ROUNDS)
        s = full_rounds(external(state), list(range(half)))
        if any(s[0].expr):  # lane 0 holds a variable: no S-box input is a constant
            s = self._partial_rounds_closed(s, [rc[r][0] for r in partial])
        else:
            for r in partial:
                s = [self.fr_add(s[0], self.const_fr(rc[r][0]))] + s[1:]
                s = [sbox(s[0])] + s[1:]
                s = internal(s)
        return full_rounds(s, list(range(half + pfr.PARTIAL_ROUNDS, pfr.N_ROUNDS)))

    def _full_rounds_fast(self, outs: List[FrVal], rounds: List[int], rc) -> List[FrVal]:
        """Full rounds whose lanes are M_E applied to the previous S-box
        outputs, twelve fresh variables: S-box i's input row is
        {w_j: M_E[i][j]} plus its round constant, as the gadgets would
        build it (M_E's entries are small positive integers), with the same
        variables, values and rows."""
        me = _external_matrix()
        for r in rounds:
            ws = [next(iter(o.expr)) for o in outs]
            vals = pfr._external_host([o.value for o in outs])
            new = []
            for i in range(pfr.WIDTH):
                row = dict(zip(ws, me[i]))
                c = rc[r][i] % FR
                if c:
                    row[0] = c
                xv = (vals[i] + c) % FR
                x2v = xv * xv % FR
                x2 = self.new_var(x2v)
                self.constraints.append((row, row, {x2: 1}))
                x4v = x2v * x2v % FR
                x4 = self.new_var(x4v)
                self.constraints.append(({x2: 1}, {x2: 1}, {x4: 1}))
                x5v = x4v * xv % FR
                x5 = self.new_var(x5v)
                self.constraints.append(({x4: 1}, row, {x5: 1}))
                new.append(FrVal(expr={x5: 1}, value=x5v))
            outs = new
        return outs

    def _partial_rounds_closed(self, s: List[FrVal], rcs: List[int]) -> List[FrVal]:
        """The partial rounds from their closed form (`_partial_coeffs`):
        S-box k's input is lane 0 plus its constant, and every lane is a
        fixed combination of the lanes entering the partial rounds and of
        the S-box outputs w_0..w_k, with coefficients that depend on the
        instance alone.  So each S-box row is read off a table instead of
        twelve expressions being rebuilt every round: the same variables,
        witness values and constraint rows (every coefficient reduced mod
        FR, as a row is).  Needs lane 0 to hold a variable, so that no
        S-box input is a constant.  Lanes that are M_E over twelve fresh
        variables (the full rounds' usual output) use tables made once."""
        K = len(rcs)
        _, gamma, mu, _, E = _partial_coeffs()
        base = _me_vars(s)
        if base is not None:
            cols = [0] + base  # column 0 is the constant
            X, F = _partial_tables_me()
        else:
            cols, X, F = _partial_tables(s)
        vals = [x.value for x in s]
        ws = []
        for k, rc in enumerate(rcs):
            if k == 0:
                xs = list(X[0])
                row = {}
            else:
                xs = list(X[k])
                row = {ws[j]: gamma[k - 1 - j] for j in range(k - 1)}
                row[ws[k - 1]] = (gamma[0] + mu[0]) % FR
            xs[0] = (xs[0] + rc) % FR
            for j, c in enumerate(xs):
                if c:
                    row[cols[j]] = c
            xv = (vals[0] + rc) % FR
            x2v = xv * xv % FR
            x2 = self.new_var(x2v)
            self.constraints.append((row, row, {x2: 1}))
            x4v = x2v * x2v % FR
            x4 = self.new_var(x4v)
            self.constraints.append(({x2: 1}, {x2: 1}, {x4: 1}))
            x5v = x4v * xv % FR
            w = self.new_var(x5v)
            self.constraints.append(({x4: 1}, row, {w: 1}))
            ws.append(w)
            vals[0] = x5v
            tv = sum(vals)
            vals = [(tv + m * v) % FR for m, v in zip(mu, vals)]
        out = []
        for i in range(pfr.WIDTH):
            expr = {cols[j]: c for j, c in enumerate(F[i]) if c}
            for j in range(K):
                if E[i][j]:
                    expr[ws[j]] = E[i][j]
            out.append(FrVal(expr=expr, value=vals[i]))
        return out

    def poseidon_fr_sponge(self, elements: List[FrVal], tag: str) -> FrVal:
        """Mirrors pfr.hash_elements_host."""
        s = [self.const_fr(0)] * pfr.WIDTH
        s[pfr.WIDTH - 1] = self.const_fr(
            (pfr._sha_to_fr("ezt-pfr-sponge/" + tag) + len(elements)) % FR
        )
        for i in range(0, len(elements), pfr.RATE):
            blk = elements[i : i + pfr.RATE]
            for j, v in enumerate(blk):
                s[j] = self.fr_add(s[j], v)
            s = self.poseidon_fr_perm(s)
        return s[0]

    def poseidon_fr_node(self, left: FrVal, right: FrVal) -> FrVal:
        """Mirrors pfr.hash_two_host."""
        s = [self.const_fr(0)] * pfr.WIDTH
        s[0], s[1] = left, right
        s[pfr.WIDTH - 1] = self.const_fr(pfr._sha_to_fr("ezt-pfr-sponge/node"))
        return self.poseidon_fr_perm(s)[0]

    def merkle_check(
        self,
        leaf_digest: FrVal,
        dir_bits: List[FrVal],
        path: List[FrVal],
        root: FrVal,
    ):
        """Fold a path to the root; dir_bits[k] = 1 means the current
        digest is the RIGHT child at level k (index bit k)."""
        assert len(dir_bits) == len(path)
        d = leaf_digest
        for b, sib in zip(dir_bits, path):
            left = self.fr_select(b, sib, d)
            right = self.fr_sub(self.fr_add(d, sib), left)  # linear complement
            d = self.poseidon_fr_node(left, right)
        self.fr_assert_eq(d, root)

    # -- finalize ------------------------------------------------------------------

    def finalize(self, public_vars: List[int]) -> tuple:
        """Reorder so publics occupy vars 1..k; returns (R1CS, witness).

        Public vars must have been allocated FIRST (vars 1..k) — the
        builder asserts rather than permuting."""
        for i, v in enumerate(public_vars):
            assert v == i + 1, "allocate public inputs before any gadget"
        r1cs = R1CS(
            num_vars=len(self.witness),
            num_public=len(public_vars),
            constraints=self.constraints,
        )
        return r1cs, list(self.witness)
