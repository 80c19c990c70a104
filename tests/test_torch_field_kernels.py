"""The port's power / inversion, masked adds and scans against the JAX package.

`MontCtx.mont_pow` / `inv` of the port (on the CPU the plain version of the
one-launch power kernel) against the JAX package's, for Fq and Fr;
`ECGroup.add_select` (the add with the scans' select inside) against
select(add) for G1 and G2; and the port's `_hs_scan` / `_blocked_seg_scan`,
which run on `add_select`, against the JAX package's eager scans, Jacobian
coordinates bit for bit.  The JAX side runs its XLA mirrors on the CPU and
is kept to a handful of points: an eager EC op costs it seconds.  Inputs
come from numpy with a fixed seed.  Tolerance: none — exact integer equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eigen_zeth_tpu.ops import bigint as jbigint
from eigen_zeth_tpu.ops import bn254 as jbn
from eigen_zeth_tpu.ops import msm as jmsm
from eigen_zeth_tpu_torch import convert
from eigen_zeth_tpu_torch.ops import bigint, bn254, kernels, msm

RNG = np.random.default_rng(0xF1E1D)
MODULI = {"fq": bn254.Q, "fr": bn254.R}
G2 = (bn254.G2_GEN_X, bn254.G2_GEN_Y)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the machine's cores; torch's own thread
    pool on top of that stalls every small op.  One thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_ints(n, modulus):
    return [int.from_bytes(RNG.bytes(32), "little") % modulus for _ in range(n)]


def _j(t):
    return jnp.asarray(convert.tensor_to_limbs(t))


def _t(a):
    return convert.limbs_to_tensor(np.asarray(a), "cpu")


# ---------------------------------------------------------------------------
# mont_pow / inv


@pytest.mark.parametrize("field", sorted(MODULI))
def test_inv_matches_jax(field):
    q = MODULI[field]
    vals = [0, 1, q - 1] + _rand_ints(5, q)
    jctx, ctx = jbigint.mont_ctx(q), bigint.mont_ctx(q)
    a = ctx.from_int(vals, "cpu")
    got = ctx.inv(a)
    assert (convert.tensor_to_limbs(got) == np.asarray(jctx.inv(_j(a)))).all()
    inv = ctx.to_int(got)
    assert inv[0] == 0 and all(int(x) * v % q == 1 for x, v in zip(inv[1:], vals[1:]))


@pytest.mark.parametrize("field", sorted(MODULI))
def test_mont_pow_matches_jax(field):
    q = MODULI[field]
    vals = [0, 1, q - 1] + _rand_ints(5, q)
    jctx, ctx = jbigint.mont_ctx(q), bigint.mont_ctx(q)
    a = ctx.from_int(vals, "cpu")
    for e in (0, 1, 0xB16B00B5):
        got = ctx.mont_pow(a, e)
        assert (convert.tensor_to_limbs(got) == np.asarray(jctx.mont_pow(_j(a), e))).all()
        assert list(ctx.to_int(got)) == [pow(v, e, q) for v in vals]


@pytest.mark.parametrize("field", sorted(MODULI))
def test_mont_pow_wrapper_on_cpu_is_its_plain_version(field):
    q = MODULI[field]
    ctx = bigint.mont_ctx(q)
    vals = [0, 1, q - 1] + _rand_ints(13, q)
    a = ctx.from_int(vals, "cpu")
    before = dict(kernels.LAUNCHES)
    for e in (0, 1, 2, q - 2, (1 << 256) - 1):
        got = kernels.mont_pow(ctx, a, e)
        assert torch.equal(got, kernels.mont_pow_plain(ctx, a, e))
        assert list(ctx.to_int(got)) == [pow(v, e, q) for v in vals]
    assert torch.equal(kernels.mont_pow(ctx, a, 0), ctx.one_mont((16,), "cpu"))
    # a batch of any rank goes through, as inv's callers hand it over
    cube = a.reshape(16, 4, 4)
    assert torch.equal(ctx.inv(cube), ctx.inv(a).reshape(16, 4, 4))
    assert kernels.LAUNCHES == before  # CPU tensors launch nothing


def test_mont_mul_takes_operands_as_they_are_or_broadcasts():
    ctx = bn254.fq()
    a = ctx.from_int(_rand_ints(6, bn254.Q), "cpu")
    b = ctx.from_int(_rand_ints(6, bn254.Q), "cpu")
    direct = ctx.mont_mul(a, b)
    assert torch.equal(direct, kernels.mont_mul_plain(ctx, a, b))
    wide = ctx.mont_mul(a.reshape(16, 6, 1), b.reshape(16, 1, 6))
    assert wide.shape == (16, 6, 6)
    assert torch.equal(wide[:, torch.arange(6), torch.arange(6)], direct)
    strided = ctx.mont_mul(a[:, ::2], b[:, ::2])
    assert torch.equal(strided, direct[:, ::2])


# ---------------------------------------------------------------------------
# add_select


def _g1_points(ks, device="cpu"):
    ctx = bn254.fq()
    pts = [bn254.h_ec_mul(k, bn254.G1_GEN) if k else None for k in ks]
    return bn254.PointJ(
        ctx.from_int([p[0] if p else 0 for p in pts], device),
        ctx.from_int([p[1] if p else 0 for p in pts], device),
        ctx.from_int([0 if p is None else 1 for p in pts], device),
    )


def _g2_points(ks, device="cpu"):
    ctx = bn254.fq()
    pts = [bn254.h_ec_mul(k, G2, bn254.HOST_FQ2) if k else None for k in ks]
    coord = lambda c, j: ctx.from_int([p[c][j] if p else 0 for p in pts], device)  # noqa: E731
    z0 = ctx.from_int([0 if p is None else 1 for p in pts], device)
    return bn254.PointJ((coord(0, 0), coord(0, 1)), (coord(1, 0), coord(1, 1)),
                        (z0, torch.zeros_like(z0)))


def _leaves(point):
    return [t for c in point for t in (c if isinstance(c, tuple) else (c,))]


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("keep", [0, 1])
def test_add_select_is_select_of_add(group, keep):
    """Distinct points, P + P, P + (-P) and infinities under all-set, none-set
    and mixed masks; an all-zero kept operand comes out all zero."""
    make, F = (_g1_points, bn254.FqOps()) if group == "g1" else (_g2_points, bn254.Fq2Ops())
    G = msm.ECGroup(F)
    a = make([1, 2, 3, 0, 5, 0, 7, 8])
    b = make([4, 2, bn254.R - 3, 6, 0, 0, 9, 1])
    full = G.add(a, b)
    n = 8
    for mask in (torch.ones(n, dtype=torch.bool), torch.zeros(n, dtype=torch.bool),
                 torch.tensor([1, 0, 0, 1, 1, 0, 1, 0], dtype=torch.bool)):
        got = G.add_select(mask, a, b, keep)
        want = G.select(mask, (a, b)[keep], full)
        assert all(torch.equal(g, w) for g, w in zip(_leaves(got), _leaves(want)))
    zero = msm._tmap(torch.zeros_like, a)
    ops = (zero, b) if keep == 0 else (a, zero)
    out = G.add_select(torch.ones(n, dtype=torch.bool), *ops, keep)
    assert all(int(t.abs().sum()) == 0 for t in _leaves(out))
    # a mask that broadcasts over a leading batch axis
    a2, b2 = (msm._tmap(lambda t: t.reshape(16, 2, 4), p) for p in (a, b))
    row = torch.tensor([1, 0, 1, 0], dtype=torch.bool)
    got = G.add_select(row, a2, b2, keep)
    want = G.select(row, (a2, b2)[keep], msm._tmap(lambda t: t.reshape(16, 2, 4), full))
    assert all(torch.equal(g, w) for g, w in zip(_leaves(got), _leaves(want)))


def test_add_select_over_plain_field_ops_agrees():
    a, b = _g1_points([1, 2, 0, 4]), _g1_points([5, 2, 3, 0])
    mask = torch.tensor([0, 0, 1, 1], dtype=torch.bool)
    got = msm.ECGroup(bn254.FqOps(plain=True)).add_select(mask, a, b, 1)
    want = msm.ECGroup(bn254.FqOps()).add_select(mask, a, b, 1)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# the scans on add_select against the JAX package's eager scans


def _scan_inputs():
    pts = _g1_points([3, 5, 0, 7, 7, 11, 13, 2])  # an infinity and a doubling inside
    flags = torch.tensor([1, 0, 0, 1, 0, 0, 1, 0], dtype=torch.bool)
    jpts = jbn.PointJ(*(_j(t) for t in pts))
    return pts, flags, jpts, jnp.asarray(flags.numpy())


def test_hs_scan_matches_jax_bit_for_bit():
    pts, flags, jpts, jflags = _scan_inputs()
    got = msm._hs_scan(msm.ECGroup(bn254.FqOps()), pts, flags)
    want = jmsm._hs_scan(jmsm.ECGroup(jbn.FqOps()), jpts, flags=jflags, eager=True)
    for g, w in zip(got, want):
        assert (convert.tensor_to_limbs(g) == np.asarray(w)).all()


def test_blocked_seg_scan_matches_jax_bit_for_bit():
    pts, flags, jpts, jflags = _scan_inputs()
    got = msm._blocked_seg_scan(msm.ECGroup(bn254.FqOps()), pts, flags, serial=4)
    want = jmsm._blocked_seg_scan(jmsm.ECGroup(jbn.FqOps()), jpts, jflags, serial=4, eager=True)
    for g, w in zip(got, want):
        assert (convert.tensor_to_limbs(g) == np.asarray(w)).all()
    # and the segment sums are the curve's: the last element of each segment
    ax, ay = bn254.to_affine(bn254.FqOps(), got)
    xs, ys = bn254.fq().to_int(ax), bn254.fq().to_int(ay)
    for end, k in ((2, 3 + 5), (5, 7 + 7 + 11), (7, 13 + 2)):
        assert (int(xs[end]), int(ys[end])) == bn254.h_ec_mul(k, bn254.G1_GEN)
