"""The port's R1CS builder and in-circuit wrap verifier against the JAX
package's.

The gadget tests of tests/test_wrap_circuit.py:33-121 run on both
packages' `Builder`s with the same calls: each circuit must be satisfied,
match its host oracle, and equal the JAX one (constraint count, variable
count, the sha256 of a canonical serialisation of the constraints, the
witness).  `build_wrap_verifier` on a wrap proof of the toy AIR (n = 16,
blowup 8, one query, 2 grinding bits) must give the JAX package's circuit,
witness and public input, and fail on a tampered proof as the JAX one does.
Tolerance: none.
"""

import copy
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from eigen_zeth_tpu.models import air as jair
from eigen_zeth_tpu.models import air_wrap as jaw
from eigen_zeth_tpu.models import r1cs_builder as jrb
from eigen_zeth_tpu.models import wrap_circuit as jwc
from eigen_zeth_tpu.ops import goldilocks as jgl
from eigen_zeth_tpu_torch.models import air, merkle_fr, r1cs_builder, wrap_circuit
from eigen_zeth_tpu_torch.ops import goldilocks as gl
from eigen_zeth_tpu_torch.ops import poseidon_fr as pfr
from test_torch_air import _bounds, _toy_air, _toy_trace

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker: the workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def canonical_sha(r1cs) -> str:
    """sha256 over every constraint's three rows, each as its (var, coeff
    mod r) pairs sorted by var (a row's dict order carries no meaning)."""
    h = hashlib.sha256(f"{r1cs.num_vars}/{r1cs.num_public}/".encode())
    for row in r1cs.constraints:
        for d in row:
            h.update(repr(sorted((v, c % pfr.R) for v, c in d.items())).encode())
        h.update(b";")
    return h.hexdigest()


def _both(build):
    """Run `build(builder)` on both packages' Builders; return the port's
    (r1cs, witness) after checking it equals the JAX one."""
    got = build(r1cs_builder.Builder())
    want = build(jrb.Builder())
    assert len(got[0].constraints) == len(want[0].constraints)
    assert got[0].num_vars == want[0].num_vars
    assert canonical_sha(got[0]) == canonical_sha(want[0])
    assert got[1] == want[1]
    assert got[0].is_satisfied(got[1])
    return got


def test_builder_fr_mul_and_bool():
    def build(b):
        z = b.fr_mul(b.witness_fr(7), b.witness_fr(11))
        assert z.value == 77
        b.fr_assert_eq(z, b.const_fr(77))
        b.fr_select(b.fr_bool(1), b.witness_fr(3), b.witness_fr(4))
        return b.finalize([])

    _both(build)


def test_builder_gl_lazy_reduction():
    big = [int(x) for x in np.random.default_rng(1).integers(0, (1 << 64) - 1, size=6,
                                                              dtype=np.uint64)]
    want = 1
    for v in big:
        want = want * v % gl.P

    def build(b):
        acc = b.gl_const(1)
        for v in big:
            acc = b.gl_mul(acc, b.gl_from_bits64(b.witness_fr(v)))
        b.gl_assert_eq(acc, b.gl_const(want))
        inv = b.gl_inv(b.gl_from_bits64(b.witness_fr(big[0])))
        assert inv.value == gl.h_inv(big[0] % gl.P)
        return b.finalize([])

    _both(build)


def test_builder_gl_sub_negative_values():
    def build(b):
        d = b.gl_sub(b.gl_const(3), b.gl_const(5))  # -2
        b.gl_assert_eq(d, b.gl_const(gl.P - 2))
        return b.finalize([])

    _both(build)


def test_builder_poseidon_gadget_matches_host():
    vals = [int(x) for x in np.random.default_rng(2).integers(0, 1 << 62, size=pfr.WIDTH)]

    def build(b):
        out = b.poseidon_fr_perm([b.witness_fr(v) for v in vals])
        for o, w in zip(out, pfr.perm_host(vals)):
            assert o.value == w
            b.fr_assert_eq(o, b.const_fr(w))
        return b.finalize([])

    r1cs, _ = _both(build)
    assert 480 <= len(r1cs.constraints) <= 520


def test_builder_constant_state_permutation_equals_jax():
    """An all-constant state: the JAX builder's constant test compares the
    exact integers it carries, and the port's must emit the same rows."""
    def build(b):
        s = [b.const_fr(v) for v in range(pfr.WIDTH)]
        s[0] = b.fr_add(b.const_fr(pfr.R - 1), b.const_fr(5))  # a sum past r
        out = b.poseidon_fr_perm(s)
        assert [o.value for o in out] == pfr.perm_host([4] + list(range(1, pfr.WIDTH)))
        return b.finalize([])

    _both(build)


def test_builder_sponge_gadget_matches_host():
    vals = [int(x) for x in np.random.default_rng(3).integers(0, 1 << 60, size=13)]

    def build(b):
        out = b.poseidon_fr_sponge([b.witness_fr(v) for v in vals], tag="leaf")
        assert out.value == pfr.hash_elements_host(vals, tag="leaf")
        return b.finalize([])

    _both(build)


def test_builder_merkle_gadget():
    vals = np.random.default_rng(4).integers(0, gl.P, (8, 3), dtype=np.uint64)
    t = merkle_fr.commit_rows_gl(gl.from_int(vals, CPU))
    idx = 5

    def build(b):
        packed = pfr.pack_gl_host([int(v) for v in vals[idx]])
        leaf = b.poseidon_fr_sponge([b.witness_fr(v) for v in packed], tag="leaf")
        bits = [b.fr_bool((idx >> i) & 1) for i in range(3)]
        path = [b.witness_fr(p) for p in t.open(idx)]
        b.merkle_check(leaf, bits, path, b.const_fr(t.root()))
        return b.finalize([])

    _both(build)


def test_builder_canonical_bits_reject_noncanonical():
    def build(b):
        bits = b.bits_canonical_fr(b.witness_fr(5))
        assert sum(bit.value << i for i, bit in enumerate(bits)) == 5
        return b.finalize([])

    r1cs, wit = _both(build)
    forged = list(wit)
    v_plus_r = 5 + pfr.R
    for i in range(254):  # the bit variables follow x
        forged[2 + i] = (v_plus_r >> i) & 1
    assert not r1cs.is_satisfied(forged)


# ---------------------------------------------------------------------------
# the wrap verifier on the toy AIR


@pytest.fixture(scope="module")
def toy_wrap():
    n, q, B, g = 16, 1, 8, 2
    trace, out = _toy_trace(n, 3, 5)
    ja = dataclasses.replace(_toy_air(jair, n), ext_blowup=B)
    jb = _bounds(jair, n, 3, 5, out)
    proof = jaw.prove_wrap(ja, jgl.from_int(trace), [3, 5, out], jb, num_queries=q, grind_bits=g)
    pa = dataclasses.replace(_toy_air(air, n), ext_blowup=B)
    return pa, ja, proof, [3, 5, out], _bounds(air, n, 3, 5, out), jb


def test_wrap_verifier_circuit_equals_jax(toy_wrap):
    pa, ja, proof, publics, bnds, jb = toy_wrap
    r1cs, wit, pub = wrap_circuit.build_wrap_verifier(pa, proof, publics, bnds, device=CPU)
    jr1cs, jwit, jpub = jwc.build_wrap_verifier(ja, proof, publics, jb)
    assert (len(r1cs.constraints), r1cs.num_vars, r1cs.num_public) == (
        len(jr1cs.constraints), jr1cs.num_vars, jr1cs.num_public)
    assert canonical_sha(r1cs) == canonical_sha(jr1cs)
    assert wit == jwit and pub == jpub
    assert pub == wrap_circuit.statement_hash(pa, publics, bnds, int(proof["shift"]),
                                              proof["num_queries"], proof["grind_bits"],
                                              device=CPU)
    assert wrap_circuit.statement_tag(pa, 7, 1, bnds, 2, device=CPU) == jwc.statement_tag(ja, 7, 1, jb, 2)
    assert wrap_circuit.final_public_input([pub, 5], "0xab") == jwc.final_public_input(
        [pub, 5], "0xab")


def test_wrap_verifier_refuses_a_tampered_proof(toy_wrap):
    pa, _, proof, publics, bnds, _ = toy_wrap
    bad = copy.deepcopy(proof)
    row = bad["trace_openings"][0][0]["row"]
    row[0] = str((int(row[0]) + 1) % gl.P)
    with pytest.raises(AssertionError):
        wrap_circuit.build_wrap_verifier(pa, bad, publics, bnds, device=CPU)
