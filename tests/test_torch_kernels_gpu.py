"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device: it is marked `gpu` and skips without
one.  The file imports only torch, numpy and the port, so it runs where JAX
is not installed:

    python -m pytest tests/test_torch_kernels_gpu.py

Inputs come from numpy with a fixed seed, at the batch proof's shapes (32
windows x 1,326 MSM points).  Tolerance: none — kernel and plain version
must agree bit for bit, and the MSM must equal the host sum of scalar
multiples.
"""

import numpy as np
import pytest
import torch

from eigen_zeth_tpu_torch.ops import bigint, bn254, kernels, msm

BATCH = 32 * 1326


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand_ints(rng, n, modulus):
    return [int.from_bytes(rng.bytes(32), "little") % modulus for _ in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("modulus", [bn254.Q, bn254.R], ids=["fq", "fr"])
def test_mont_mul_kernel_matches_plain(modulus):
    dev = _cuda()
    rng = np.random.default_rng(1)
    ctx = bigint.mont_ctx(modulus)
    a, b = _rand_ints(rng, BATCH, modulus), _rand_ints(rng, BATCH, modulus)
    a[:4], b[:4] = [0, 1, modulus - 1, modulus - 1], [modulus - 1, modulus - 1, 1, 0]
    ta, tb = ctx.from_int(a, dev), ctx.from_int(b, dev)
    before = kernels.LAUNCHES["mont_mul"]
    got = kernels.mont_mul(ctx, ta, tb)
    assert kernels.LAUNCHES["mont_mul"] == before + 1
    assert torch.equal(got, kernels.mont_mul_plain(ctx, ta, tb))


@pytest.mark.gpu
def test_point_add_kernel_matches_plain():
    dev = _cuda()
    rng = np.random.default_rng(2)
    ctx = bn254.fq()
    pts = [bn254.h_ec_mul(k, bn254.G1_GEN) for k in range(1, 7)]
    neg1 = (pts[1][0], (-pts[1][1]) % bn254.Q)
    P = pts + [pts[0], pts[1], None, pts[2], None]  # ..., P+P, P+(-P), inf+P, P+inf, inf+inf
    Q = pts[::-1] + [pts[0], neg1, pts[3], None, None]

    def coords(points):
        n = BATCH - len(points)
        xs = [p[0] if p else 0 for p in points] + _rand_ints(rng, n, bn254.Q)
        ys = [p[1] if p else 0 for p in points] + _rand_ints(rng, n, bn254.Q)
        zs = [0 if p is None else 1 for p in points] + _rand_ints(rng, n, bn254.Q)
        return tuple(ctx.from_int(v, dev) for v in (xs, ys, zs))

    p, q = coords(P), coords(Q)
    before = kernels.LAUNCHES["point_add"]
    got = kernels.point_add(ctx, p, q)
    assert kernels.LAUNCHES["point_add"] == before + 1
    for g, r in zip(got, kernels.point_add_plain(ctx, p, q)):
        assert torch.equal(g, r)
    ax, ay = bn254.to_affine(bn254.FqOps(), bn254.PointJ(*(t[:, : len(P)] for t in got)))
    xs, ys = ctx.to_int(ax), ctx.to_int(ay)
    for i, (u, v) in enumerate(zip(P, Q)):
        want = bn254.h_ec_add(u, v)
        assert (want is None and xs[i] == 0 and ys[i] == 0) or want == (xs[i], ys[i])


@pytest.mark.gpu
def test_msm_g1_on_the_card_matches_host():
    dev = _cuda()
    rng = np.random.default_rng(3)
    n = 300
    pts = [bn254.h_ec_mul(int(k), bn254.G1_GEN) for k in rng.integers(1, 2**30, n)]
    sc = _rand_ints(rng, n, bn254.R)
    want = None
    for p, s in zip(pts, sc):
        want = bn254.h_ec_add(want, bn254.h_ec_mul_jac_f(s, p))
    kernels.reset_launches()
    assert msm.msm_g1(pts, sc, device=dev) == want
    assert kernels.LAUNCHES["point_add"] > 0 and kernels.LAUNCHES["mont_mul"] > 0
