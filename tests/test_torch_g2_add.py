"""The port's G2 point add and G2 MSM against the JAX package, on the CPU.

`kernels.point_add_g2` (on the CPU its plain version) against the JAX
package's `bn254.point_add(Fq2Ops(), ...)` on a small batch with the five
degenerate pairings, every Jacobian coordinate bit for bit; the masked form
against select(add); `msm_g2`, whose scans now run on the masked add, against
the JAX package's host Pippenger.  The JAX side runs eagerly on the CPU and
sees one small batch.  Inputs come from numpy with a fixed seed.
Tolerance: none — exact integer equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eigen_zeth_tpu.models import groth16 as jgroth16
from eigen_zeth_tpu.ops import bn254 as jbn
from eigen_zeth_tpu_torch import convert
from eigen_zeth_tpu_torch.ops import bn254, kernels, msm

RNG = np.random.default_rng(0x62ADD)
G2 = (bn254.G2_GEN_X, bn254.G2_GEN_Y)
H2 = bn254.HOST_FQ2


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


def _edge_pairs():
    pts = [bn254.h_ec_mul(k, G2, H2) for k in range(1, 6)]
    neg1 = (pts[1][0], H2.neg(pts[1][1]))
    P = pts + [pts[0], pts[1], None, pts[2], None]  # ..., P+P, P+(-P), inf+P, P+inf, inf+inf
    Q = pts[::-1] + [pts[0], neg1, pts[3], None, None]
    return P, Q


def _jac(points, n_random=0):
    """G2 Jacobian limbs of host affine points (z = 1, or 0 for infinity),
    followed by n_random triples of random Fq2 coordinates."""
    ctx = bn254.fq()

    def plane(pick, fill):
        return ctx.from_int([pick(p) if p else fill for p in points]
                            + _rand_ints(n_random, bn254.Q), "cpu")

    xy = [tuple(plane(lambda p, c=c, j=j: p[c][j], 0) for j in range(2)) for c in range(2)]
    z0 = ctx.from_int([0 if p is None else 1 for p in points] + _rand_ints(n_random, bn254.Q),
                      "cpu")
    z1 = ctx.from_int([0] * len(points) + _rand_ints(n_random, bn254.Q), "cpu")
    return (*xy, (z0, z1))


def _leaves(point):
    return [t for coord in point for t in coord]


def _jpoint(p):
    return jbn.PointJ(*(tuple(jnp.asarray(convert.tensor_to_limbs(t)) for t in c) for c in p))


def test_point_add_g2_matches_jax():
    P, Q = _edge_pairs()
    p, q = _jac(P, 3), _jac(Q, 3)
    ctx = bn254.fq()
    before = dict(kernels.LAUNCHES)
    got = kernels.point_add_g2(ctx, p, q)
    assert kernels.LAUNCHES == before  # CPU tensors launch nothing
    want = jbn.point_add(jbn.Fq2Ops(), _jpoint(p), _jpoint(q))
    for g, w in zip(_leaves(got), _leaves(want)):
        assert (convert.tensor_to_limbs(g) == np.asarray(w)).all()
    # the degenerate cases mean what they should: affine against host math
    F2 = bn254.Fq2Ops()
    head = bn254.PointJ(*(tuple(t[:, : len(P)] for t in c) for c in got))
    (x0, x1), (y0, y1) = (F2.to_int(c) for c in bn254.to_affine(F2, head))
    for i, (u, v) in enumerate(zip(P, Q)):
        want_aff = bn254.h_ec_add(u, v, H2) or ((0, 0), (0, 0))
        assert ((int(x0[i]), int(x1[i])), (int(y0[i]), int(y1[i]))) == want_aff, i


def test_point_add_g2_is_the_generic_add_over_fq2():
    """The wrapper's plain version and the dispatching generic add agree, and
    ECGroup sends G2 through the wrapper."""
    P, Q = _edge_pairs()
    p, q = _jac(P, 2), _jac(Q, 2)
    ctx = bn254.fq()
    got = kernels.point_add_g2(ctx, p, q)
    generic = bn254.point_add(bn254.Fq2Ops(), bn254.PointJ(*p), bn254.PointJ(*q))
    group = msm.ECGroup(bn254.Fq2Ops()).add(bn254.PointJ(*p), bn254.PointJ(*q))
    for g, a, b in zip(_leaves(got), _leaves(generic), _leaves(group)):
        assert torch.equal(g, a) and torch.equal(g, b)


@pytest.mark.parametrize("keep", [0, 1])
def test_masked_point_add_g2_is_select_of_add(keep):
    P, Q = _edge_pairs()
    p, q = _jac(P, 2), _jac(Q, 2)
    ctx = bn254.fq()
    n = len(P) + 2
    full = kernels.point_add_g2(ctx, p, q)
    mixed = torch.tensor(RNG.integers(0, 2, n) * 3, dtype=torch.int32)
    for mask in (torch.ones(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32), mixed):
        got = kernels.point_add_g2(ctx, p, q, mask, keep)
        for g, k, f in zip(_leaves(got), _leaves((p, q)[keep]), _leaves(full)):
            assert torch.equal(g, torch.where(mask != 0, k, f))


def test_msm_g2_on_masked_adds_matches_host_pippenger():
    n = 33  # pads to 64: two serial lanes of 32
    pts = [bn254.h_ec_mul_jac_f(int(k), G2, H2) for k in RNG.integers(1, 2**40, n)]
    sc = _rand_ints(n, bn254.R)
    sc[0], sc[1] = 0, 1
    pts[2] = None
    pts[3], sc[3] = pts[4], sc[4]  # a repeated point in one bucket: a doubling
    assert msm.msm_g2(pts, sc, device="cpu") == jgroth16.host_pippenger(pts, sc, g2=True)
