"""The port's BN254 field, curve and MSM against the JAX package.

Kernel A's plain version is held against `MontCtx._mont_mul_xla`, kernel
B's against `bn254.point_add` (the XLA mirrors of the Pallas kernels, run
eagerly on the CPU), and the MSMs against the JAX package's host
Pippenger (tests/test_torch_kernels_gpu.py holds the CUDA kernels against
these plain versions on the card).  Inputs come from numpy with a fixed
seed.  Tolerance: none — exact integer equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eigen_zeth_tpu.models import groth16 as jgroth16
from eigen_zeth_tpu.ops import bigint as jbigint
from eigen_zeth_tpu.ops import bn254 as jbn
from eigen_zeth_tpu_torch import convert
from eigen_zeth_tpu_torch.ops import bigint, bn254, kernels, msm

RNG = np.random.default_rng(0xB254)
MODULI = {"fq": bn254.Q, "fr": bn254.R}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run spreads files over several worker processes on the
    machine's cores; torch's own thread pool on top of that oversubscribes
    the cores and stalls every small op at its barrier.  One thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_ints(n, modulus):
    return [int.from_bytes(RNG.bytes(32), "little") % modulus for _ in range(n)]


def _operands(modulus, n=256):
    a, b = _rand_ints(n, modulus), _rand_ints(n, modulus)
    a[:4], b[:4] = [0, 1, modulus - 1, modulus - 1], [modulus - 1, modulus - 1, 1, 0]
    return a, b


@pytest.mark.parametrize("field", sorted(MODULI))
def test_plain_mont_mul_matches_xla_mirror(field):
    q = MODULI[field]
    a, b = _operands(q)
    jctx, ctx = jbigint.mont_ctx(q), bigint.mont_ctx(q)
    want = np.asarray(jctx._mont_mul_xla(jctx.from_int(a), jctx.from_int(b)))
    got = kernels.mont_mul_plain(ctx, ctx.from_int(a, "cpu"), ctx.from_int(b, "cpu"))
    assert (convert.tensor_to_limbs(got) == want).all()
    # the dispatching entry point takes the plain version for CPU tensors
    assert torch.equal(ctx.mont_mul(ctx.from_int(a, "cpu"), ctx.from_int(b, "cpu")), got)


@pytest.mark.parametrize("op", ["add", "sub"])
def test_limb_add_sub_match_jax(op):
    a, b = _operands(bn254.Q)
    jctx, ctx = jbigint.mont_ctx(bn254.Q), bigint.mont_ctx(bn254.Q)
    want = np.asarray(getattr(jctx, op)(jctx.from_int(a), jctx.from_int(b)))
    got = getattr(ctx, op)(ctx.from_int(a, "cpu"), ctx.from_int(b, "cpu"))
    assert (convert.tensor_to_limbs(got) == want).all()


def test_neg_inv_and_converters():
    a, _ = _operands(bn254.Q, 32)
    jctx, ctx = jbigint.mont_ctx(bn254.Q), bigint.mont_ctx(bn254.Q)
    ta = ctx.from_int(a, "cpu")
    assert (convert.tensor_to_limbs(ta) == np.asarray(jctx.from_int(a))).all()
    assert (convert.tensor_to_limbs(ctx.neg(ta)) == np.asarray(jctx.neg(jctx.from_int(a)))).all()
    assert list(ctx.to_int(ta)) == a
    assert torch.equal(convert.limbs_to_tensor(np.asarray(jctx.from_int(a)), "cpu"), ta)
    inv = ctx.to_int(ctx.inv(ta[:, 4:12]))
    assert all(int(x) * v % bn254.Q == 1 for x, v in zip(inv, a[4:12]))


def _edge_points():
    pts = [jbn.h_ec_mul(k, jbn.G1_GEN) for k in range(1, 9)]
    neg1 = (pts[1][0], (-pts[1][1]) % bn254.Q)
    P = pts + [pts[0], pts[1], None, pts[2], None]
    Q = pts[::-1] + [pts[0], neg1, pts[3], None, None]
    return P, Q  # ..., P+P, P+(-P), inf+P, P+inf, inf+inf


def _jac(ctx, points, device):
    xs = ctx.from_int([p[0] if p else 0 for p in points], device)
    ys = ctx.from_int([p[1] if p else 0 for p in points], device)
    zs = ctx.from_int([0 if p is None else 1 for p in points], device)
    return xs, ys, zs


def test_plain_point_add_matches_xla_mirror():
    P, Q = _edge_points()
    jctx, ctx = jbigint.mont_ctx(bn254.Q), bigint.mont_ctx(bn254.Q)
    jp = jbn.PointJ(*(jnp.asarray(convert.tensor_to_limbs(t)) for t in _jac(ctx, P, "cpu")))
    jq = jbn.PointJ(*(jnp.asarray(convert.tensor_to_limbs(t)) for t in _jac(ctx, Q, "cpu")))
    want = jbn.point_add(jbn.FqOps(), jp, jq)
    got = kernels.point_add_plain(ctx, _jac(ctx, P, "cpu"), _jac(ctx, Q, "cpu"))
    for w, g in zip(want, got):
        assert (convert.tensor_to_limbs(g) == np.asarray(w)).all()
    ax, ay = bn254.to_affine(bn254.FqOps(), bn254.PointJ(*got))
    xs, ys = ctx.to_int(ax), ctx.to_int(ay)
    for i, (p, q) in enumerate(zip(P, Q)):
        expect = jbn.h_ec_add(p, q)
        assert (expect is None and xs[i] == 0 and ys[i] == 0) or expect == (xs[i], ys[i])


def test_point_double_matches_jax():
    P, _ = _edge_points()
    ctx = bigint.mont_ctx(bn254.Q)
    jp = jbn.PointJ(*(jnp.asarray(convert.tensor_to_limbs(t)) for t in _jac(ctx, P, "cpu")))
    want = jbn.point_double(jbn.FqOps(), jp)
    got = bn254.point_double(bn254.FqOps(), bn254.PointJ(*_jac(ctx, P, "cpu")))
    for w, g in zip(want, got):
        assert (convert.tensor_to_limbs(g) == np.asarray(w)).all()


def test_from_affine_to_affine_round_trip():
    P, _ = _edge_points()
    F = bn254.FqOps()
    xs = F.ctx.from_int([p[0] if p else 0 for p in P], "cpu")
    ys = F.ctx.from_int([p[1] if p else 0 for p in P], "cpu")
    inf = torch.tensor([p is None for p in P])
    ax, ay = bn254.to_affine(F, bn254.from_affine(F, xs, ys, is_inf=inf))
    assert torch.equal(ax, xs) and torch.equal(ay, ys)


def test_scalar_digits_match_jax():
    from eigen_zeth_tpu.ops import msm as jmsm

    sc = _rand_ints(50, bn254.R)
    assert (msm.scalar_digits(sc) == jmsm.scalar_digits(sc)).all()
    limbs = torch.from_numpy(msm.scalar_limbs(sc).astype(np.int64))
    assert (msm.digits_from_limbs(limbs).numpy() == jmsm.scalar_digits(sc)).all()


def _g1_instance(n):
    ks = [int(x) for x in RNG.integers(1, 2**62, n)]
    pts = [jbn.h_ec_mul_jac(k, jbn.G1_GEN) for k in ks]
    sc = _rand_ints(n, bn254.R)
    sc[0], sc[1] = 0, 1
    pts[2] = None
    pts[3], sc[3] = pts[4], sc[4]  # a repeated point in one bucket
    return pts, sc


def test_msm_g1_matches_host_pippenger():
    pts, sc = _g1_instance(600)
    assert msm.msm_g1(pts, sc, device="cpu") == jgroth16.host_pippenger(pts, sc)


def test_msm_g1_below_one_lane():
    """Fewer points than one serial lane: the padding infinities fill it."""
    pts, sc = _g1_instance(5)
    assert msm.msm_g1(pts, sc, device="cpu") == jgroth16.host_pippenger(pts, sc)


def test_msm_g2_matches_host_pippenger():
    n = 40
    pts = [jbn.h_ec_mul_jac_f(int(k), jgroth16.G2_GEN, jbn.HOST_FQ2)
           for k in RNG.integers(1, 2**40, n)]
    sc = _rand_ints(n, bn254.R)
    assert msm.msm_g2(pts, sc, device="cpu") == jgroth16.host_pippenger(pts, sc, g2=True)
