"""The port's Goldilocks field and NTT against the JAX package.

Inputs come from numpy with a fixed seed; the same values go through the
JAX functions (run eagerly on the CPU) or their numpy references and
through the port on CPU tensors.  Tolerance: none — every comparison is
exact integer equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eigen_zeth_tpu.ops import goldilocks as jgl
from eigen_zeth_tpu.ops import ntt as jntt
from eigen_zeth_tpu_torch import convert
from eigen_zeth_tpu_torch.ops import goldilocks as gl
from eigen_zeth_tpu_torch.ops import ntt

P = gl.P
EDGE = np.array([0, 1, P - 1, 2**32 - 1, 2**32, 2**63, 2**63 - 1, P - 2**32], dtype=np.uint64)


def _pair(seed: int, n: int = 512):
    rng = np.random.default_rng(seed)
    a = np.concatenate([EDGE, rng.integers(0, P, n, dtype=np.uint64)])
    b = np.concatenate([EDGE[::-1], rng.integers(0, P, n, dtype=np.uint64)])
    return a, b


def _jax(fn, *xs):
    out = fn(*(jgl.from_int(x) for x in xs))
    return jgl.to_int(out)


def _port(fn, *xs):
    return gl.to_int(fn(*(gl.from_int(x, "cpu") for x in xs)))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_jax(op):
    a, b = _pair(1)
    # every edge value meets every other edge value as well
    ea, eb = np.meshgrid(EDGE, EDGE)
    a = np.concatenate([a, ea.ravel()])
    b = np.concatenate([b, eb.ravel()])
    assert (_port(getattr(gl, op), a, b) == _jax(getattr(jgl, op), a, b)).all()


@pytest.mark.parametrize("op", ["neg", "square", "inv"])
def test_unary_ops_match_jax(op):
    a, _ = _pair(2, 128)
    assert (_port(getattr(gl, op), a) == _jax(getattr(jgl, op), a)).all()


@pytest.mark.parametrize("e", [0, 1, 7, 2**32 + 5, P - 2])
def test_pow_const_matches_jax(e):
    a, _ = _pair(3, 64)
    got = gl.to_int(gl.pow_const(gl.from_int(a, "cpu"), e))
    assert (got == jgl.to_int(jgl.pow_const(jgl.from_int(a), e))).all()


def test_batch_inv_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.integers(1, P, (3, 100), dtype=np.uint64)
    a[0, :3] = [1, P - 1, 2**32]
    got = gl.to_int(gl.batch_inv(gl.from_int(a, "cpu")))
    assert (got == jgl.to_int(jgl.batch_inv(jgl.from_int(a)))).all()
    assert (gl.np_mulmod(got, a) == 1).all()


def test_powers_and_select_match_jax():
    assert (gl.to_int(gl.powers(12345, 77, "cpu")) == jgl.to_int(jgl.powers(12345, 77))).all()
    a, b = _pair(5, 32)
    pred = np.random.default_rng(5).integers(0, 2, len(a)).astype(bool)
    got = gl.to_int(gl.select(torch.from_numpy(pred), gl.from_int(a, "cpu"), gl.from_int(b, "cpu")))
    want = jgl.to_int(jgl.select(jnp.asarray(pred), jgl.from_int(a), jgl.from_int(b)))
    assert (got == want).all()


def test_host_helpers_are_the_jax_ones():
    for order in (2, 64, 1 << 20):
        assert gl.primitive_root_of_unity(order) == jgl.primitive_root_of_unity(order)
    a, b = _pair(6, 64)
    assert (gl.np_mulmod(a, b) == jgl.np_mulmod(a, b)).all()
    assert (gl.powers_np(7, 100) == jgl.powers_np(7, 100)).all()
    assert (gl.np_addmod(a, b) == jgl.np_addmod(a, b)).all()
    assert (gl.np_submod(a, b) == jgl.np_submod(a, b)).all()
    assert (gl.np_ntt(a[:64]) == jgl.np_ntt(a[:64])).all()
    assert (gl.np_intt(a[:64]) == jgl.np_intt(a[:64])).all()


@pytest.mark.parametrize("log_n", range(4, 13))
def test_ntt_intt_match_numpy_reference(log_n):
    n = 1 << log_n
    x = np.random.default_rng(log_n).integers(0, P, (2, n), dtype=np.uint64)
    fwd = gl.to_int(ntt.ntt(gl.from_int(x, "cpu")))
    inv = gl.to_int(ntt.intt(gl.from_int(x, "cpu")))
    for row in range(2):
        assert (fwd[row] == jgl.np_ntt(x[row])).all()
        assert (inv[row] == jgl.np_intt(x[row])).all()
    back = gl.to_int(ntt.intt(gl.from_int(fwd, "cpu")))
    assert (back == x).all()


@pytest.mark.parametrize("n,blowup", [(16, 4), (64, 4), (32, 8)])
def test_lde_matches_jax(n, blowup):
    c = np.random.default_rng(n + blowup).integers(0, P, n, dtype=np.uint64)
    got = gl.to_int(ntt.lde(gl.from_int(c, "cpu"), blowup))
    assert (got == jgl.to_int(jntt.lde(jgl.from_int(c), blowup))).all()


def test_coset_shift_matches_jax():
    c = np.random.default_rng(9).integers(0, P, 64, dtype=np.uint64)
    for inverse in (False, True):
        got = gl.to_int(ntt.coset_shift(gl.from_int(c, "cpu"), 7, inverse=inverse))
        want = jgl.to_int(jntt.coset_shift(jgl.from_int(c), 7, inverse=inverse))
        assert (got == want).all()


def test_gf_converters_round_trip():
    a, _ = _pair(7, 100)
    g = jgl.from_int_np(a)
    t = convert.gf_to_tensor(g.lo, g.hi, "cpu")
    assert (gl.to_int(t) == a).all()
    lo, hi = convert.tensor_to_gf(t)
    assert (lo == g.lo).all() and (hi == g.hi).all()


@pytest.mark.parametrize("block_cols", [None, 1, 2, 5])
def test_lde_columns_in_blocks_matches_the_whole_transform(block_cols):
    """The AIR prover's blocked INTT + coset LDE of a column matrix (here the
    transpose of a (rows, columns) trace, a strided view) equals the unblocked
    transform and the JAX package's."""
    rows = np.random.default_rng(77).integers(0, gl.P, (64, 5), dtype=np.uint64)
    cols = gl.from_int(rows, "cpu").T
    got = ntt.lde_columns(cols, 8, 7, block_cols=block_cols)
    assert got.shape == (5, 512)
    assert torch.equal(got, ntt.lde(ntt.intt(cols), 8, 7))
    want = jntt.lde(jntt.intt(jgl.from_int(np.ascontiguousarray(rows.T))), 8, 7)
    assert (gl.to_int(got) == jgl.to_int(want)).all()
