"""The port's verifier AIR and chunk attestation against the JAX package's.

Two child shapes, as in tests/test_recursion.py: an 8-row chunk with
zero-layer FRI (terminal 32 = the LDE domain) and a 32-row chunk with
terminal 32 (two fold layers verified inside the AIR), both with 2 child
queries and 8 queries of the aggregation STARK.  The chunk proof is made
once (by the JAX package; the port's chunk prover is held equal to it in
tests/test_torch_stark.py) and handed to both packages.  Tolerance: none —
the verifier traces must be equal as numpy arrays, the attestations equal
as dicts, each package's `verify_attestation` must accept the other's
attestation, and the JAX package's tamper cases must hold in the port.

An attestation costs the CPU tens of seconds (the plain Poseidon2 over
2^14 to 2^15 wide rows), so the cases are spread over three files that the
test run places on different workers: this one holds the zero-layer shape,
tests/test_torch_recursion_fold.py runs the same checks on the fold-layer
shape, and tests/test_torch_recursion_tamper.py holds the chunk proofs
that cannot be attested.
"""

import json

import numpy as np
import pytest
import torch

from eigen_zeth_tpu.models import recursion as jrec
from eigen_zeth_tpu.models import stark as jstark
from eigen_zeth_tpu.ops import goldilocks as jgl
from eigen_zeth_tpu.protocol.prover_service import chunk_digest as jchunk_digest
from eigen_zeth_tpu_torch.models import recursion as rec
from eigen_zeth_tpu_torch.models import stark
from eigen_zeth_tpu_torch.ops import goldilocks as gl
from eigen_zeth_tpu_torch.protocol.prover_service import chunk_digest

P = gl.P
CPU = torch.device("cpu")
AGG_Q = 8
# name -> (trace rows, data length, pinned terminal for verify_attestation)
SHAPES = {"zero-layer": (8, 7, None), "two-fold-layers": (32, 29, 32)}
PARAMS = dict(blowup=4, num_queries=2, terminal_size=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker: the workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_child(name):
    rows, length, _ = SHAPES[name]
    rng = np.random.default_rng(0x5EC + rows)
    data = [int(v) for v in rng.integers(0, P, length, dtype=np.uint64)]
    iv = int(rng.integers(0, P, dtype=np.uint64))
    child = jstark.prove_chunk(data, iv=iv, params=jstark.StarkParams(**PARAMS), n_rows=rows)
    assert stark.verify_chunk(child, stark.StarkParams(**PARAMS))
    return json.loads(json.dumps(child))


def make_bundle(name):
    """(shape name, child proof, JAX attestation, the port's attestation)."""
    child = make_child(name)
    jatt = jrec.attest_chunk(child, num_queries_agg=AGG_Q)
    att = rec.attest_chunk(child, num_queries_agg=AGG_Q, device=CPU)
    return name, child, jatt, att


@pytest.fixture(scope="module")
def bundle():
    return make_bundle("zero-layer")


def _pin(name):
    terminal = SHAPES[name][2]
    return {} if terminal is None else {"expected_terminal": terminal}


def test_verifier_trace_equals_the_jax_package(bundle):
    name, child, _, _ = bundle
    jair, jtrace, jpub, jbnd = jrec.build_verifier_trace(child, 2)
    air, trace, pub, bnd = rec.build_verifier_trace(child, 2)
    assert isinstance(trace, np.ndarray) and trace.dtype == np.uint64
    assert trace.shape == (jair.n, jair.n_cols) == (air.n, air.n_cols)
    assert (trace == jgl.to_int(jtrace)).all()
    assert pub == jpub
    assert [(b.col, b.row, b.value) for b in bnd] == [(b.col, b.row, b.value) for b in jbnd]
    assert air.name == jair.name and len(air.constraints) == len(jair.constraints)
    assert [c.arity for c in air.constraints] == [c.arity for c in jair.constraints]
    assert all((a == b).all() for a, b in zip(air.periodic, jair.periodic))


def test_layout_and_schedule_are_the_jax_ones():
    for n_c, terminal in ((8, None), (32, 32), (4096, 64)):
        lay, jlay = rec.Layout(n_c, terminal), jrec.Layout(n_c, terminal)
        sch, jsch = rec.Schedule(n_c, terminal), jrec.Schedule(n_c, terminal)
        assert vars(lay) == vars(jlay)
        assert (sch.L, sch.slots, sch.arith_row, sch.fpend_rows) == (
            jsch.L, jsch.slots, jsch.arith_row, jsch.fpend_rows)
    assert rec.Layout(4096, 64).n_cols == 216 and rec.Schedule(4096, 64).L == 8192


def test_attestation_is_identical_to_the_jax_package(bundle):
    _, _, jatt, att = bundle
    assert att == jatt
    assert json.dumps(att) == json.dumps(jatt)


def test_each_verifier_accepts_the_others_attestation(bundle):
    name, child, jatt, att = bundle
    assert rec.verify_attestation(jatt, **_pin(name)) == chunk_digest(child)
    assert jrec.verify_attestation(att, **_pin(name)) == jchunk_digest(child)
    assert chunk_digest(child) == jchunk_digest(child)


@pytest.mark.parametrize("field", ["trace_root", "out", "coeff", "air_proof", "roots"])
def test_tampered_attestation_is_rejected(bundle, field):
    name, _, _, att = bundle
    bad = json.loads(json.dumps(att))
    h = bad["header"]
    if field == "trace_root":
        h["trace_root"][0] = str((int(h["trace_root"][0]) + 1) % P)
    elif field == "out":
        h["public"]["out"] = str((int(h["public"]["out"]) + 1) % P)
    elif field == "coeff":
        h["final_coeffs"][0] = str((int(h["final_coeffs"][0]) + 1) % P)
    elif field == "air_proof":
        row = bad["air_proof"]["trace_openings"][0][0]["row"]
        row[5] = str((int(row[5]) + 1) % P)
    elif not h["roots"]:  # a zero-layer child has no fold roots: claim one
        h["roots"] = [list(h["trace_root"])]
    else:  # a changed fold root shifts the replayed betas and indices
        h["roots"][0][0] = str((int(h["roots"][0][0]) + 1) % P)
    with pytest.raises(ValueError):
        rec.verify_attestation(bad, **_pin(name))


def test_query_count_rows_and_terminal_are_pinned(bundle):
    name, _, _, att = bundle
    rows = SHAPES[name][0]
    assert rec.verify_attestation(att, expected_queries=2, expected_rows=rows, **_pin(name))
    with pytest.raises(ValueError):
        rec.verify_attestation(att, expected_queries=4, expected_rows=rows, **_pin(name))
    with pytest.raises(ValueError):
        rec.verify_attestation(att, expected_queries=2, expected_rows=2 * rows, **_pin(name))
    with pytest.raises(ValueError):
        rec.verify_attestation(att, expected_terminal=64)
    if SHAPES[name][2] is not None:
        with pytest.raises(ValueError):  # fold layers need the terminal pinned
            rec.verify_attestation(att)


def test_host_helpers_are_the_jax_ones(bundle):
    _, child, _, _ = bundle
    header, jheader = rec.child_header(child), jrec.child_header(child)
    assert header == jheader
    assert rec.replay_child(header, 2) == jrec.replay_child(jheader, 2)
    assert rec.header_terminal(header) == jrec.header_terminal(jheader)
    idx = [3, 0, 5]
    assert rec.chain_digest(idx) == jrec.chain_digest(idx)
    assert rec.coeffs_digest(header["final_coeffs"]) == jrec.coeffs_digest(header["final_coeffs"])
    rng = np.random.default_rng(0x5ED)
    st = rng.integers(0, P, (3, 12), dtype=np.uint64)
    for got, want in zip(rec._perm_rows_np(st), jrec._perm_rows_np(st)):
        assert (got == want).all()


def test_wrap_profile_names_the_next_slice(bundle):
    """The wrap-profile functions are ported: the instance a wrap
    attestation pins is the JAX package's, and a GL attestation (no wrap
    proof) is refused by the wrap checker."""
    _, _, jatt, att = bundle
    air, publics, bnds = rec.wrap_attestation_instance(att, wrap_blowup=32)
    jair, jpublics, jbnds = jrec.wrap_attestation_instance(jatt, wrap_blowup=32)
    assert (air.n, air.n_cols, air.ext_blowup, air.name) == (jair.n, jair.n_cols, 32, jair.name)
    assert publics == jpublics
    assert [(b.col, b.row, b.value) for b in bnds] == [(b.col, b.row, b.value) for b in jbnds]
    with pytest.raises(KeyError):
        rec.verify_attestation_wrap(att, device=CPU)
