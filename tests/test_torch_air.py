"""The port's general AIR prover and verifier against the JAX package's.

The toy AIR of tests/test_air.py (two columns, a period-4 selector that
alternates Fibonacci and multiply rows, three boundary constraints) is
proved by `eigen_zeth_tpu.models.air.prove` (its numpy mode, the default on
the CPU, which the JAX package's own tests hold equal to its jitted path)
and by the port on CPU tensors.  The trace comes from numpy.  Tolerance:
none — the two proof dicts must be equal, each verifier must accept the
other's proof and reject a tampered one.
"""

import json

import numpy as np
import pytest
import torch

from eigen_zeth_tpu.models import air as jair
from eigen_zeth_tpu.ops import goldilocks as jgl
from eigen_zeth_tpu_torch.models import air
from eigen_zeth_tpu_torch.ops import goldilocks as gl

P = gl.P
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker: the workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _constraints():
    def c0(a, cur, nxt, per):
        s = per[0]
        fib = a.sub(nxt[0], cur[1])
        mul = a.sub(nxt[0], a.mul(cur[0], cur[1]))
        return a.add(a.mul(s, fib), a.sub(mul, a.mul(s, mul)))

    def c1(a, cur, nxt, per):
        s = per[0]
        fib = a.sub(nxt[1], a.add(cur[0], cur[1]))
        hold = a.sub(nxt[1], cur[1])
        return a.add(a.mul(s, fib), a.sub(hold, a.mul(s, hold)))

    # the same two constraints once more as one family of arity 2, so that
    # the stacked path of the composition is compared too
    def fam(a, cur, nxt, per):
        return a.stack([c0(a, cur, nxt, per), c1(a, cur, nxt, per)])

    return [("c0", c0, 1), ("c1", c1, 1), ("fam", fam, 2)]


def _toy_air(mod, n):
    sel = np.array([1, 1, 1, 0], dtype=np.uint64)
    cons = [mod.Constraint(name, fn, arity=k) for name, fn, k in _constraints()]
    return mod.Air(n=n, n_cols=2, periodic=[sel], constraints=cons, name="toy-fib-mul")


def _toy_trace(n, x0, x1):
    a = np.zeros(n, dtype=np.uint64)
    b = np.zeros(n, dtype=np.uint64)
    a[0], b[0] = x0, x1
    for r in range(n - 1):
        if r % 4 != 3:
            a[r + 1] = b[r]
            b[r + 1] = (int(a[r]) + int(b[r])) % P
        else:
            a[r + 1] = int(a[r]) * int(b[r]) % P
            b[r + 1] = b[r]
    return np.stack([a, b], axis=1), int(b[n - 1])


def _bounds(mod, n, x0, x1, out):
    return [mod.Boundary(0, 0, x0), mod.Boundary(1, 0, x1), mod.Boundary(1, n - 1, out)]


@pytest.fixture(scope="module", params=[(64, 8), (32, 2)], ids=["n64-q8", "n32-q2"])
def bundle(request):
    n, queries = request.param
    x0, x1 = (int(v) for v in np.random.default_rng(0xA12 + n).integers(1, P, 2, dtype=np.uint64))
    rows, out = _toy_trace(n, x0, x1)
    publics = [x0, x1, out]
    jproof = jair.prove(_toy_air(jair, n), jgl.from_int(rows), publics,
                        _bounds(jair, n, x0, x1, out), num_queries=queries)
    proof = air.prove(_toy_air(air, n), gl.from_int(rows, CPU), publics,
                      _bounds(air, n, x0, x1, out), num_queries=queries)
    return n, (x0, x1, out), jproof, proof


def test_proof_is_identical_to_the_jax_package(bundle):
    _, _, jproof, proof = bundle
    assert proof == jproof
    assert json.dumps(proof) == json.dumps(jproof)


def test_each_verifier_accepts_the_others_proof(bundle):
    n, (x0, x1, out), jproof, proof = bundle
    publics = [x0, x1, out]
    assert air.verify(_toy_air(air, n), jproof, publics, _bounds(air, n, x0, x1, out))
    assert jair.verify(_toy_air(jair, n), proof, publics, _bounds(jair, n, x0, x1, out))


@pytest.mark.parametrize("what", ["opening", "root", "boundary", "publics", "fri"])
def test_both_verifiers_reject_a_tampered_proof(bundle, what):
    n, (x0, x1, out), _, proof = bundle
    publics = [x0, x1, out]
    bad = json.loads(json.dumps(proof))
    bnd_out = out
    if what == "opening":
        row = bad["trace_openings"][0][0]["row"]
        row[0] = str((int(row[0]) + 1) % P)
    elif what == "root":
        bad["trace_root"][0] = str((int(bad["trace_root"][0]) + 1) % P)
    elif what == "boundary":
        bnd_out = (out + 1) % P
    elif what == "publics":
        publics = [x0, x1, (out + 1) % P]
    else:
        bad["fri"]["final_coeffs"][0] = str((int(bad["fri"]["final_coeffs"][0]) + 1) % P)
    assert not air.verify(_toy_air(air, n), bad, publics, _bounds(air, n, x0, x1, bnd_out))
    assert not jair.verify(_toy_air(jair, n), bad, publics, _bounds(jair, n, x0, x1, bnd_out))


def test_an_invalid_trace_is_unprovable():
    n = 64
    rows, _ = _toy_trace(n, 3, 5)
    rows[17, 0] = (int(rows[17, 0]) + 1) % P
    bnds = [air.Boundary(0, 0, 3), air.Boundary(1, 0, 5)]
    with pytest.raises(AssertionError):
        air.prove(_toy_air(air, n), gl.from_int(rows, CPU), [3, 5], bnds, num_queries=8)


def test_composition_in_blocks_equals_one_block(monkeypatch):
    """The composition over blocks of the coset (with the next-row view
    wrapping at the end) gives the proof of the unblocked one."""
    n = 64
    rows, out = _toy_trace(n, 3, 5)
    args = (gl.from_int(rows, CPU), [3, 5, out], _bounds(air, n, 3, 5, out))
    whole = air.prove(_toy_air(air, n), *args, num_queries=4)
    monkeypatch.setattr(air, "COMP_BLOCK", 64)
    assert air.prove(_toy_air(air, n), *args, num_queries=4) == whole


def test_dev_alg_matches_host_alg():
    rng = np.random.default_rng(0xA19)
    m = 16
    x = rng.integers(0, P, (5, m), dtype=np.uint64)
    mat = rng.integers(0, P, (3, 5), dtype=np.uint64)
    vec = rng.integers(0, P, 5, dtype=np.uint64)
    dev, host = air.DevAlg((m,), CPU), air.HostAlg()
    xt = gl.from_int(x, CPU)
    got = gl.to_int(dev.matvec(dev.const_matrix(mat), xt))
    assert (got == np.stack([host.matvec(mat, x[:, j]) for j in range(m)], axis=1)).all()
    assert (gl.to_int(dev.sum0(xt)) == host.sum0(x)).all()
    got = gl.to_int(dev.scale_rows(dev.const_matrix(vec), xt[0]))
    assert (got == np.stack([host.scale_rows(vec, x[0, j]) for j in range(m)], axis=1)).all()
    assert gl.to_int(dev.concat0([xt[0], xt[1:3], dev.zeros(2)])).shape == (5, m)
    assert int(gl.to_int(dev.full(P + 3))[0]) == 3 and int(gl.to_int(dev.c(P + 3)).reshape(-1)[0]) == 3


def test_periodic_columns_on_host_and_device_agree():
    n = 32
    a = _toy_air(air, n)
    lde = gl.to_int(a.periodic_lde(gl.MULTIPLICATIVE_GENERATOR, CPU))
    m = n * a.ext_blowup
    w = gl.primitive_root_of_unity(m)
    xs = [gl.h_mul(gl.MULTIPLICATIVE_GENERATOR, gl.h_pow(w, j)) for j in (0, 1, 7, m - 1)]
    many = a.periodic_at_many(xs)
    for i, j in enumerate((0, 1, 7, m - 1)):
        assert int(lde[0, j]) == int(many[0, i]) == a.periodic_at(xs[i])[0]
    ja = _toy_air(jair, n)
    assert (many == ja.periodic_at_many(xs)).all()
    assert a.fri_params(5) == air.fri.FriParams(blowup=4, num_queries=5, terminal_size=64)
    assert a.fri_params(5).grind_bits == ja.fri_params(5).grind_bits == 0
