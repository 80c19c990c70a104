"""The port's wrap-profile STARK against the JAX package's.

The toy AIR of tests/test_torch_air.py (the one of tests/test_air.py and
tests/test_air_wrap.py: two columns, a period-4 selector, three boundary
constraints) is proved in the wrap profile by the JAX package's
`prove_wrap` and by the port's on CPU tensors, at n = 16 and 64, blowups
32 and 8, 1 and 4 queries, 2 and 4 grinding bits.  The proof JSON must be
equal byte for byte; each package's `verify_wrap` accepts the other's
proof, and the port's rejects every tamper case of
tests/test_air_wrap.py:128-163 and a proof checked against other pinned
query or grind counts.  Tolerance: none.
"""

import copy
import dataclasses
import json

import pytest
import torch

from eigen_zeth_tpu.models import air as jair
from eigen_zeth_tpu.models import air_wrap as jaw
from eigen_zeth_tpu.ops import goldilocks as jgl
from eigen_zeth_tpu_torch.models import air, air_wrap
from eigen_zeth_tpu_torch.ops import goldilocks as gl
from eigen_zeth_tpu_torch.ops import poseidon_fr as pfr
from test_torch_air import _bounds, _toy_air, _toy_trace

CPU = torch.device("cpu")
# (n, queries, blowup, grind bits)
CASES = {"n16-q1-b32-g2": (16, 1, 32, 2), "n64-q4-b8-g4": (64, 4, 8, 4)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker: the workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bundle(case):
    n, q, B, g = CASES[case]
    trace, out = _toy_trace(n, 3, 5)
    publics = [3, 5, out]
    jproof = jaw.prove_wrap(dataclasses.replace(_toy_air(jair, n), ext_blowup=B),
                            jgl.from_int(trace), publics, _bounds(jair, n, 3, 5, out),
                            num_queries=q, grind_bits=g)
    pa = dataclasses.replace(_toy_air(air, n), ext_blowup=B)
    bnds = _bounds(air, n, 3, 5, out)
    proof = air_wrap.prove_wrap(pa, gl.from_int(trace, CPU), publics, bnds, num_queries=q,
                                grind_bits=g)
    return pa, proof, jproof, publics, bnds, out


@pytest.fixture(scope="module", params=sorted(CASES))
def bundle(request):
    return _bundle(request.param)


def test_prove_wrap_is_byte_identical(bundle):
    _, proof, jproof, _, _, _ = bundle
    assert json.dumps(proof) == json.dumps(jproof)


def test_each_verifier_accepts_the_other_proof(bundle):
    pa, proof, jproof, publics, bnds, out = bundle
    n, B = pa.n, pa.ext_blowup
    assert air_wrap.verify_wrap(pa, jproof, publics, bnds,
                                expected_queries=proof["num_queries"],
                                expected_grind_bits=proof["grind_bits"], device=CPU)
    ja = dataclasses.replace(_toy_air(jair, n), ext_blowup=B)
    assert jaw.verify_wrap(ja, proof, publics, _bounds(jair, n, 3, 5, out))


def _tampered(proof, what):
    bad = copy.deepcopy(proof)
    if what == "trace-root":
        bad["trace_root"] = str((int(proof["trace_root"]) + 1) % pfr.R)
    elif what == "opening":
        row = bad["trace_openings"][0][0]["row"]
        row[0] = str((int(row[0]) + 1) % gl.P)
    elif what == "fri-layer":
        if bad["fri"]["queries"][0]["layers"]:
            lay = bad["fri"]["queries"][0]["layers"][0]
            lay["u"] = str((int(lay["u"]) + 1) % gl.P)
        else:  # zero-layer shape: corrupt the terminal polynomial instead
            fc = bad["fri"]["final_coeffs"]
            fc[0] = str((int(fc[0]) + 1) % gl.P)
    elif what == "const-opening":
        row = bad["const_openings"][0][1]["row"]
        row[0] = str((int(row[0]) + 1) % gl.P)
    elif what == "grind-nonce":
        bad["fri"]["grind_nonce"] = str(int(proof["fri"]["grind_nonce"]) + 1)
    elif what == "const-root":
        bad["const_root"] = str((int(proof["const_root"]) + 1) % pfr.R)
    return bad


@pytest.mark.parametrize("what", ["trace-root", "opening", "fri-layer", "const-opening",
                                  "grind-nonce", "const-root"])
def test_verify_wrap_rejects_tampering(bundle, what):
    pa, proof, _, publics, bnds, _ = bundle
    assert not air_wrap.verify_wrap(pa, _tampered(proof, what), publics, bnds, device=CPU)


def test_verify_wrap_rejects_wrong_instance_and_pins(bundle):
    pa, proof, _, publics, bnds, out = bundle
    bad_bnds = list(bnds[:-1]) + [air.Boundary(1, pa.n - 1, (out + 1) % gl.P)]
    assert not air_wrap.verify_wrap(pa, proof, publics, bad_bnds, device=CPU)
    assert not air_wrap.verify_wrap(pa, proof, [3, 6, out], bnds, device=CPU)
    assert not air_wrap.verify_wrap(pa, proof, publics, bnds,
                                    expected_queries=proof["num_queries"] + 1, device=CPU)
    assert not air_wrap.verify_wrap(pa, proof, publics, bnds,
                                    expected_grind_bits=proof["grind_bits"] + 1, device=CPU)


def test_constants_root_is_recomputable(bundle):
    pa, proof, _, _, _, _ = bundle
    fresh = dataclasses.replace(_toy_air(air, pa.n), ext_blowup=pa.ext_blowup)
    air_wrap._CONST_TREES.clear()  # a fresh process: nothing committed yet
    assert air_wrap.constants_root(fresh, gl.MULTIPLICATIVE_GENERATOR, CPU) == int(proof["const_root"])
    ja = dataclasses.replace(_toy_air(jair, pa.n), ext_blowup=pa.ext_blowup)
    assert jaw.constants_root(ja, gl.MULTIPLICATIVE_GENERATOR) == int(proof["const_root"])
