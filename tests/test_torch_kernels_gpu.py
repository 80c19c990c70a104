"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device: it is marked `gpu` and skips without
one.  The file imports only torch, numpy and the port, so it runs where JAX
is not installed:

    python -m pytest tests/test_torch_kernels_gpu.py

Inputs come from numpy with a fixed seed, at the batch proof's shapes (32
windows x 1,326 MSM points; the scan step and the mixed add at a quarter of
that).  Tolerance: none — kernel and plain version must agree bit for bit,
and the MSMs must equal the host sum of scalar multiples.
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


def _step_inputs(dev, n):
    """Accumulator, affine point, sign and flag planes for kernels C and D:
    edge cases first (zero accumulator under a flag, P + P, P + (-P), the
    accumulator at infinity, the same under a flag, y = 0 with the sign
    set), then random field elements."""
    rng = np.random.default_rng(4)
    ctx = bn254.fq()
    pts = [bn254.h_ec_mul(k, bn254.G1_GEN) for k in range(1, 5)]
    P, negP = pts[0], (pts[0][0], (-pts[0][1]) % bn254.Q)
    edge = [
        ((0, 0, 0), pts[1], 1, 1), (P + (1,), P, 0, 0), (P + (1,), negP, 0, 0),
        (pts[2] + (0,), pts[3], 0, 0), (P + (1,), P, 0, 1), (P + (1,), negP, 0, 1),
        (pts[2] + (0,), pts[3], 1, 1), (pts[2] + (1,), (pts[3][0], 0), 1, 1),
    ]
    m = n - len(edge)
    cols = [[e[0][k] for e in edge] + _rand_ints(rng, m, bn254.Q) for k in range(3)]
    cols += [[e[1][k] for e in edge] + _rand_ints(rng, m, bn254.Q) for k in range(2)]
    planes = tuple(ctx.from_int(c, dev) for c in cols)
    sgn = torch.tensor([e[2] for e in edge] + rng.integers(0, 2, m).tolist(),
                       dtype=torch.int32, device=dev)
    flg = torch.tensor([e[3] for e in edge] + rng.integers(0, 2, m).tolist(),
                       dtype=torch.int32, device=dev)
    return ctx, planes[:3], planes[3:], sgn, flg


@pytest.mark.gpu
def test_scan_step_kernel_matches_plain():
    dev = _cuda()
    ctx, acc, q_aff, sgn, flg = _step_inputs(dev, BATCH // 4)
    before = kernels.LAUNCHES["point_scan_step"]
    got = kernels.point_scan_step(ctx, acc, q_aff, sgn, flg)
    assert kernels.LAUNCHES["point_scan_step"] == before + 1
    for g, r in zip(got, kernels.point_scan_step_plain(ctx, acc, q_aff, sgn, flg)):
        assert torch.equal(g, r)
    assert got[3][:8].tolist() == [0, 1, 1, 1, 0, 0, 0, 0]
    assert int(got[1][:, 7].abs().sum()) == 0  # -0 = 0 under the sign


@pytest.mark.gpu
def test_point_madd_kernel_matches_plain():
    dev = _cuda()
    ctx, acc, q_aff, _, _ = _step_inputs(dev, BATCH // 4)
    before = kernels.LAUNCHES["point_madd"]
    got = kernels.point_madd(ctx, acc, q_aff)
    assert kernels.LAUNCHES["point_madd"] == before + 1
    for g, r in zip(got, kernels.point_madd_plain(ctx, acc, q_aff)):
        assert torch.equal(g, r)
    assert got[3][:8].tolist() == [1, 1, 1, 1, 1, 1, 1, 0]
    # the field-generic entry point goes to the kernel for CUDA tensors
    out, bad = bn254.point_madd_unsafe(bn254.FqOps(), bn254.PointJ(*acc), *q_aff)
    assert kernels.LAUNCHES["point_madd"] == before + 2
    assert all(torch.equal(o, g) for o, g in zip(out, got[:3])) and torch.equal(bad, got[3] != 0)


@pytest.mark.gpu
def test_cuda_tensors_never_take_a_plain_version():
    """A CUDA tensor the kernel does not take raises; nothing falls back."""
    dev = _cuda()
    ctx, acc, q_aff, sgn, flg = _step_inputs(dev, 64)
    with pytest.raises(TypeError):
        kernels.point_scan_step(ctx, acc, q_aff, sgn.bool(), flg)
    with pytest.raises(ValueError):
        kernels.point_scan_step(ctx, acc, q_aff, sgn.cpu(), flg)
    with pytest.raises(ValueError):
        kernels.point_madd(ctx, acc, (q_aff[0].cpu(), q_aff[1]))


@pytest.mark.gpu
def test_msm_g1_device_on_the_card_matches_host():
    dev = _cuda()
    rng = np.random.default_rng(5)
    n = 300
    pts = [bn254.h_ec_mul(int(k), bn254.G1_GEN) for k in rng.integers(1, 2**30, n)]
    sc = _rand_ints(rng, n, bn254.R)
    want = None
    for p, s in zip(pts, sc):
        want = bn254.h_ec_add(want, bn254.h_ec_mul_jac_f(s, p))
    F = bn254.FqOps()
    xs = F.ctx.from_int([p[0] for p in pts], dev)
    ys = F.ctx.from_int([p[1] for p in pts], dev)
    inf = torch.zeros(n, dtype=torch.bool, device=dev)
    kernels.reset_launches()
    assert msm.msm_g1_device(xs, ys, inf, sc) == want
    # 300 = 4 x 75: the serial depth halves from 32 to 4; c = 8 gives 32 windows
    assert kernels.LAUNCHES["point_scan_step"] == 4
    assert kernels.LAUNCHES["point_add"] > 0 and kernels.LAUNCHES["mont_mul"] > 0
    assert msm.msm_g1_fast(pts, sc, device=dev) == want
