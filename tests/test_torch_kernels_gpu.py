"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device: it is marked `gpu` and skips without
one.  The file imports only torch, numpy and the port, so it runs where JAX
is not installed:

    python -m pytest tests/test_torch_kernels_gpu.py

Inputs come from numpy with a fixed seed, at the batch proof's shapes (32
windows x 1,326 MSM points; the scan step and the mixed add at a quarter of
that; the G2 and masked adds at an eighth; kernel E, Poseidon2 over
Goldilocks, on rows of every kind of length, column-major and strided
inputs, and a tiny attestation proved on the card against the CPU's;
kernel F, Poseidon2 over BN254 Fr, through its three entry points with
edge states, and the card's grind search against the host's).
Tolerance: none — kernel and
plain version must agree bit for bit, and the MSMs must equal the host sum
of scalar multiples.
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
    with pytest.raises(TypeError):
        kernels.mont_pow(ctx, acc[0].long(), 5)
    with pytest.raises(ValueError):
        kernels.mont_pow(ctx, acc[0], 1 << 256)
    with pytest.raises(ValueError):
        kernels.mont_pow(ctx, acc[0][:, ::2], 5)
    with pytest.raises(TypeError):
        kernels.point_add(ctx, acc, acc, mask=sgn.bool())
    with pytest.raises(ValueError):
        kernels.point_add(ctx, acc, acc, mask=sgn.cpu())
    with pytest.raises(ValueError):
        kernels.point_add(ctx, acc, acc, mask=sgn, keep=2)
    pair = lambda t: (t, t)  # noqa: E731
    g2 = tuple(map(pair, acc))
    with pytest.raises(ValueError):
        kernels.point_add_g2(ctx, g2, tuple((t.cpu(), t) for t in acc))
    with pytest.raises(ValueError):
        kernels.point_add_g2(ctx, g2, g2, mask=sgn[:32].contiguous())
    with pytest.raises(ValueError):
        kernels.mont_mul(bigint.MontCtx((1 << 256) - 189), acc[0], acc[0])


EDGE_WORDS = [0, 1, 2, (1 << 256) - 1, (1 << 255) - 1, (1 << 224) - 1, 0xFFFFFFFF,
              0xFFFFFFFF << 224, 1 << 255, 1 << 128]


@pytest.mark.gpu
@pytest.mark.parametrize("modulus", [bn254.Q, bn254.R], ids=["fq", "fr"])
def test_field_core_on_carry_edge_operands(modulus):
    """Operands whose words are all ones, q - 1, R mod q and their like, in
    every pairing: a wrong carry shows on these and rarely on random values.
    The squaring inside mont_pow(a, 2) must equal the product a·a."""
    dev = _cuda()
    ctx = bigint.mont_ctx(modulus)
    vals = sorted({v % modulus for v in EDGE_WORDS} | {modulus - 1, modulus - 2, ctx.R_mod,
                                                       ctx.R2_mod, modulus >> 1})
    # from_int(mont=False): the listed values ARE the Montgomery words
    a = ctx.from_int([x for x in vals for _ in vals], dev, mont=False)
    b = ctx.from_int([y for _ in vals for y in vals], dev, mont=False)
    got = kernels.mont_mul(ctx, a, b)
    assert torch.equal(got, kernels.mont_mul_plain(ctx, a, b))
    rinv = pow(ctx.R, -1, modulus)
    want = [x * y * rinv % modulus for x in vals for y in vals]
    assert list(ctx.to_int(got, mont=False)) == want
    assert torch.equal(kernels.mont_pow(ctx, a, 2), kernels.mont_mul(ctx, a, a))


@pytest.mark.gpu
@pytest.mark.parametrize("modulus", [bn254.Q, bn254.R], ids=["fq", "fr"])
def test_mont_pow_kernel_matches_plain(modulus):
    dev = _cuda()
    rng = np.random.default_rng(6)
    ctx = bigint.mont_ctx(modulus)
    vals = [0, 1, modulus - 1] + _rand_ints(rng, 61, modulus)
    a = ctx.from_int(vals, dev)
    for e in (0, 1, 2, 3, modulus - 2, (1 << 256) - 1, int.from_bytes(rng.bytes(32), "little")):
        before = kernels.LAUNCHES["mont_pow"]
        got = kernels.mont_pow(ctx, a, e)
        assert kernels.LAUNCHES["mont_pow"] == before + 1
        assert torch.equal(got, kernels.mont_pow_plain(ctx, a, e)), e
        assert list(ctx.to_int(got)) == [pow(v, e, modulus) for v in vals]
    before = dict(kernels.LAUNCHES)
    inv = ctx.to_int(ctx.inv(a))
    assert kernels.LAUNCHES["mont_pow"] == before["mont_pow"] + 1
    assert kernels.LAUNCHES["mont_mul"] == before["mont_mul"]
    assert inv[0] == 0 and all(int(x) * v % modulus == 1 for x, v in zip(inv[1:], vals[1:]))


def _g2_inputs(dev, n):
    """Two batches of G2 Jacobian points: the five degenerate pairings and a
    few honest ones on real points, then random field elements."""
    rng = np.random.default_rng(7)
    ctx = bn254.fq()
    G2 = (bn254.G2_GEN_X, bn254.G2_GEN_Y)
    pts = [bn254.h_ec_mul(k, G2, bn254.HOST_FQ2) for k in range(1, 7)]
    neg1 = (pts[1][0], bn254.HOST_FQ2.neg(pts[1][1]))
    P = pts + [pts[0], pts[1], None, pts[2], None]  # ..., P+P, P+(-P), inf+P, P+inf, inf+inf
    Q = pts[::-1] + [pts[0], neg1, pts[3], None, None]

    def coords(points):
        m = n - len(points)
        out = []
        for c in range(2):
            out.append(tuple(
                ctx.from_int([p[c][j] if p else 0 for p in points] + _rand_ints(rng, m, bn254.Q),
                             dev) for j in range(2)))
        z0 = ctx.from_int([0 if p is None else 1 for p in points] + _rand_ints(rng, m, bn254.Q),
                          dev)
        z1 = ctx.from_int([0] * len(points) + _rand_ints(rng, m, bn254.Q), dev)
        return (*out, (z0, z1))

    return ctx, P, Q, coords(P), coords(Q)


def _leaves(point):
    return [t for coord in point for t in (coord if isinstance(coord, tuple) else (coord,))]


@pytest.mark.gpu
def test_point_add_g2_kernel_matches_plain():
    dev = _cuda()
    ctx, P, Q, p, q = _g2_inputs(dev, BATCH // 8)
    before = kernels.LAUNCHES["point_add_g2"]
    got = kernels.point_add_g2(ctx, p, q)
    assert kernels.LAUNCHES["point_add_g2"] == before + 1
    ref = kernels.point_add_g2_plain(ctx, p, q)
    for g, r in zip(_leaves(got), _leaves(ref)):
        assert torch.equal(g, r)
    F2 = bn254.Fq2Ops()
    head = bn254.PointJ(*(tuple(t[:, : len(P)].contiguous() for t in c) for c in got))
    (x0, x1), (y0, y1) = (F2.to_int(c) for c in bn254.to_affine(F2, head))
    for i, (u, v) in enumerate(zip(P, Q)):
        want = bn254.h_ec_add(u, v, bn254.HOST_FQ2)
        have = ((int(x0[i]), int(x1[i])), (int(y0[i]), int(y1[i])))
        assert have == (want if want is not None else ((0, 0), (0, 0))), i


@pytest.mark.gpu
@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("keep", [0, 1])
def test_masked_point_add_matches_plain(group, keep):
    """All lanes passed, none passed, and a mixed mask, for both operands;
    a passed all-zero operand comes out all zero."""
    dev = _cuda()
    n = BATCH // 8
    if group == "g1":
        ctx, acc, _, _, _ = _step_inputs(dev, n)
        p, q = acc, tuple(t.flip(1).contiguous() for t in acc)
        add, plain, name = kernels.point_add, kernels.point_add_plain, "point_add"
    else:
        ctx, _, _, p, q = _g2_inputs(dev, n)
        add, plain, name = kernels.point_add_g2, kernels.point_add_g2_plain, "point_add_g2"
    rng = np.random.default_rng(8)
    mixed = torch.tensor(rng.integers(0, 2, n), dtype=torch.int32, device=dev)
    mixed[:40] = torch.tensor([1, 0] * 20, dtype=torch.int32, device=dev)
    for mask in (torch.ones_like(mixed), torch.zeros_like(mixed), mixed * 7):
        before = kernels.LAUNCHES[name + "_masked"]
        got = add(ctx, p, q, mask, keep)
        assert kernels.LAUNCHES[name + "_masked"] == before + 1
        for g, r in zip(_leaves(got), _leaves(plain(ctx, p, q, mask, keep))):
            assert torch.equal(g, r)
    kept = _leaves((p, q)[keep])
    for g, k in zip(_leaves(add(ctx, p, q, torch.ones_like(mixed), keep)), kept):
        assert torch.equal(g, k)
    zero = tuple(torch.zeros_like(t) for t in _leaves(p))
    zero = zero if group == "g1" else tuple(zip(zero[::2], zero[1::2]))
    out = add(ctx, *((zero, q) if keep == 0 else (p, zero)), torch.ones_like(mixed), keep)
    assert all(int(t.abs().sum()) == 0 for t in _leaves(out))


@pytest.mark.gpu
def test_msm_g2_on_the_card_matches_host():
    dev = _cuda()
    rng = np.random.default_rng(9)
    n = 70
    G2 = (bn254.G2_GEN_X, bn254.G2_GEN_Y)
    pts = [bn254.h_ec_mul_jac_f(int(k), G2, bn254.HOST_FQ2) for k in rng.integers(1, 2**30, n)]
    sc = _rand_ints(rng, n, bn254.R)
    sc[0], sc[1] = 0, 1
    pts[3], sc[3] = pts[4], sc[4]
    want = None
    for p, s in zip(pts, sc):
        want = bn254.h_ec_add(want, bn254.h_ec_mul_jac_f(s, p, bn254.HOST_FQ2), bn254.HOST_FQ2)
    kernels.reset_launches()
    assert msm.msm_g2(pts, sc, device=dev) == want
    assert kernels.LAUNCHES["point_add_g2"] > 0 and kernels.LAUNCHES["mont_pow"] == 1
    assert kernels.LAUNCHES["point_add_g2_masked"] == kernels.LAUNCHES["point_add_g2"]
    assert kernels.LAUNCHES["mont_mul"] <= 16


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


# ---------------------------------------------------------------------------
# kernel E: Poseidon2 over Goldilocks


def _gl_words(rng, shape, dev):
    from eigen_zeth_tpu_torch.ops import goldilocks as gl

    return gl.from_int(rng.integers(0, gl.P, shape, dtype=np.uint64), dev)


@pytest.mark.gpu
def test_poseidon2_perm_kernel_matches_plain():
    from eigen_zeth_tpu_torch.ops import goldilocks as gl
    from eigen_zeth_tpu_torch.ops import poseidon

    dev = _cuda()
    states = _gl_words(np.random.default_rng(10), (3, 1000, 12), dev)
    states[0, 0], states[0, 1], states[0, 2, ::2] = 0, gl.as_i64(gl.P - 1), gl.as_i64(gl.P - 1)
    before = kernels.LAUNCHES["poseidon2"]
    got = poseidon.perm(states)
    assert kernels.LAUNCHES["poseidon2"] == before + 1
    assert got.shape == states.shape and torch.equal(got, poseidon.perm_plain(states))
    for i in range(3):
        host = poseidon.perm_host([int(v) for v in gl.to_int(states[0, i])])
        assert [int(v) for v in gl.to_int(got[0, i])] == host
    assert poseidon.perm(states[:0]).shape == (0, 1000, 12)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [0, 1, 7, 8, 9, 13, 16, 216])
def test_poseidon2_hash_rows_kernel_matches_plain(k):
    from eigen_zeth_tpu_torch.ops import goldilocks as gl
    from eigen_zeth_tpu_torch.ops import poseidon

    dev = _cuda()
    n = 777
    cols = _gl_words(np.random.default_rng(11 + k), (k, n), dev)
    cols[:, 0], cols[:, 1] = 0, gl.as_i64(gl.P - 1)
    rows = cols.T  # column-major rows, read through their strides
    before = kernels.LAUNCHES["poseidon2"]
    got = poseidon.hash_elements(rows)
    assert kernels.LAUNCHES["poseidon2"] == before + 1
    assert got.shape == (n, 4) and torch.equal(got, poseidon.hash_elements_plain(rows))
    assert torch.equal(poseidon.hash_elements(rows.contiguous()), got)
    assert torch.equal(poseidon.hash_elements(rows.reshape(7, 111, k)), got.reshape(7, 111, 4))
    for i in (0, 1, n - 1):
        host = poseidon.hash_elements_host([int(v) for v in gl.to_int(rows[i])])
        assert [int(v) for v in gl.to_int(got[i])] == host


@pytest.mark.gpu
def test_poseidon2_hash_two_kernel_and_merkle_tree_match_plain():
    from eigen_zeth_tpu_torch.models import merkle
    from eigen_zeth_tpu_torch.ops import goldilocks as gl
    from eigen_zeth_tpu_torch.ops import poseidon

    dev = _cuda()
    level = _gl_words(np.random.default_rng(12), (2, 4096, 4), dev)
    level[0, 0], level[0, 1] = 0, gl.as_i64(gl.P - 1)
    left, right = level[:, 0::2], level[:, 1::2]  # strided digests, read in place
    before = kernels.LAUNCHES["poseidon2"]
    got = poseidon.hash_two(left, right)
    assert kernels.LAUNCHES["poseidon2"] == before + 1
    assert torch.equal(got, poseidon.hash_two_plain(left, right))
    host = poseidon.hash_two_host([int(v) for v in gl.to_int(left[0, 0])],
                                  [int(v) for v in gl.to_int(right[0, 0])])
    assert [int(v) for v in gl.to_int(got[0, 0])] == host
    # a whole tree over wide rows: 1 launch for the leaves, 1 for the 8 levels
    rows = _gl_words(np.random.default_rng(13), (256, 13), dev)
    before = kernels.LAUNCHES["poseidon2"]
    tree = merkle.commit_tree(rows)
    assert kernels.LAUNCHES["poseidon2"] == before + 1 + 1
    cpu_tree = merkle.commit_tree(rows.cpu())
    assert tree.root() == cpu_tree.root() and tree.open_many([0, 77, 255]) == cpu_tree.open_many([0, 77, 255])
    with pytest.raises(TypeError):
        poseidon.hash_two(left.to(torch.int32), right.to(torch.int32))
    with pytest.raises(ValueError):
        poseidon.hash_two(left, right.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("n,trees", [(2, 1), (8, 3), (512, 1), (2048, 2), (1 << 12, 9),
                                     (1 << 14, 1), (1 << 15, 2)])
def test_poseidon2_merkle_levels_kernel_matches_plain(n, trees):
    from eigen_zeth_tpu_torch.models import merkle
    from eigen_zeth_tpu_torch.ops import goldilocks as gl
    from eigen_zeth_tpu_torch.ops import poseidon

    dev = _cuda()
    digests = _gl_words(np.random.default_rng(20 + n.bit_length()), (trees, 2 * n, 4), dev)
    digests[0, 0], digests[0, 2] = 0, gl.as_i64(gl.P - 1)
    for level in (digests[:, :n], digests[:, 0::2]):  # contiguous rows, strided rows
        before = kernels.LAUNCHES["poseidon2"]
        got = poseidon.merkle_levels(level)
        assert kernels.LAUNCHES["poseidon2"] == before + 1
        want = poseidon.merkle_levels_plain(level)
        assert len(got) == n.bit_length() - 1 and got[-1].shape == (trees, 1, 4)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.is_contiguous() and torch.equal(g, w)
    top = got[0][0, 0]  # one node against the host compression
    host = poseidon.hash_two_host([int(v) for v in gl.to_int(digests[0, 0])],
                                  [int(v) for v in gl.to_int(digests[0, 2])])
    assert [int(v) for v in gl.to_int(top)] == host
    if trees == 1:  # a 2-D level, and the commit against the CPU's
        assert torch.equal(poseidon.merkle_levels(level[0])[-1], got[-1][0])
        assert all(torch.equal(a.cpu(), b) for a, b in
                   zip(merkle.commit_digests(level), merkle.commit_digests(level.cpu())))
    with pytest.raises(ValueError):
        poseidon.merkle_levels(digests[:, : n + 1])  # not a power of two
    with pytest.raises(TypeError):
        poseidon.merkle_levels(level.to(torch.int32))


@pytest.mark.gpu
def test_poseidon2_lazy_bound_states_match_plain_and_host():
    """States aimed at the lazy core's bounds: lanes 0, 1, p - 1, p - 2^32,
    2^32 - 1, 2^32 and states whose partial-round products mu_i·s_i sit near
    their maximum (every lane p - 1)."""
    from eigen_zeth_tpu_torch.ops import goldilocks as gl
    from eigen_zeth_tpu_torch.ops import poseidon

    dev = _cuda()
    P = gl.P
    edge = [0, 1, P - 1, P - (1 << 32), (1 << 32) - 1, 1 << 32]
    rng = np.random.default_rng(21)
    rows = [[v] * 12 for v in edge] + [list(rng.choice(edge, 12)) for _ in range(250)]
    states = gl.from_int(np.asarray(rows, dtype=np.uint64), dev)
    got = poseidon.perm(states)
    assert torch.equal(got, poseidon.perm_plain(states))
    for i in range(0, len(rows), 7):
        assert [int(v) for v in gl.to_int(got[i])] == poseidon.perm_host([int(v) for v in rows[i]])
    # the same words absorbed by the sponge and compressed as digests
    flat = states.reshape(-1, 24)
    assert torch.equal(poseidon.hash_elements(flat), poseidon.hash_elements_plain(flat))
    assert torch.equal(poseidon.hash_two(states[:, :4], states[:, 4:8]),
                       poseidon.hash_two_plain(states[:, :4], states[:, 4:8]))


@pytest.mark.gpu
def test_attestation_on_the_card_equals_the_cpu_one():
    """The tiny zero-layer attestation proved on the card (kernel E in every
    Merkle commit) and on the CPU (the plain versions): the same dict."""
    from eigen_zeth_tpu_torch.models import recursion, stark

    dev = _cuda()
    params = stark.StarkParams(blowup=4, num_queries=2, terminal_size=32)
    child = stark.prove_chunk([3, 1, 4, 1, 5, 9, 2], 7, params, n_rows=8, device=dev)
    assert child == stark.prove_chunk([3, 1, 4, 1, 5, 9, 2], 7, params, n_rows=8, device="cpu")
    kernels.reset_launches()
    att = recursion.attest_chunk(child, num_queries_agg=8, device=dev)
    assert kernels.LAUNCHES["poseidon2"] > 0
    assert att == recursion.attest_chunk(child, num_queries_agg=8, device=torch.device("cpu"))
    assert recursion.verify_attestation(att, expected_queries=2, expected_rows=8)


# ---------------------------------------------------------------------------
# kernel F: Poseidon2 over BN254 Fr


def _fr_edge_states(rng, n):
    """n random Fr states with edge lanes (0, 1, r - 1, 2^64 - 1, 2^192 - 1)
    in the first rows."""
    from eigen_zeth_tpu_torch.ops import poseidon_fr as pfr

    states = [[int.from_bytes(rng.bytes(32), "little") % pfr.R for _ in range(12)]
              for _ in range(n)]
    edges = [0, 1, pfr.R - 1, (1 << 64) - 1, (1 << 192) - 1]
    for i, e in enumerate(edges):
        states[i] = [e] * 12
    states[len(edges)] = (edges * 3)[:12]
    return states


@pytest.mark.gpu
def test_poseidon_fr_perm_kernel_matches_plain_and_host():
    from eigen_zeth_tpu_torch.ops import poseidon_fr as pfr

    dev = _cuda()
    rng = np.random.default_rng(21)
    states = _fr_edge_states(rng, 300)
    words = pfr.words_from_ints(states, dev)
    before = kernels.LAUNCHES["poseidon_fr"]
    got = pfr.perm_device(words)
    assert kernels.LAUNCHES["poseidon_fr"] == before + 1
    assert torch.equal(got, pfr.perm_fr_plain(words))
    for i in (0, 1, 2, 3, 4, 5, 299):
        assert pfr.ints_from_words(got[i]) == pfr.perm_host(states[i])


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 3, 4, 33, 34, 216])
def test_poseidon_fr_hash_rows_kernel_matches_plain(k):
    from eigen_zeth_tpu_torch.ops import goldilocks as gl
    from eigen_zeth_tpu_torch.ops import poseidon_fr as pfr

    dev = _cuda()
    rng = np.random.default_rng(22 + k)
    vals = rng.integers(0, gl.P, (256, k), dtype=np.uint64)
    vals[0] = gl.P - 1
    vals[1] = 0
    rows = gl.from_int(vals, dev)
    cols = gl.from_int(np.ascontiguousarray(vals.T), dev)  # column-major view below
    before = kernels.LAUNCHES["poseidon_fr"]
    got = kernels.poseidon_fr_hash_rows(rows)
    got_t = kernels.poseidon_fr_hash_rows(cols.T)
    assert kernels.LAUNCHES["poseidon_fr"] == before + 2
    want = pfr.hash_rows_fr_plain(rows)
    assert torch.equal(got, want) and torch.equal(got_t, want)
    for i in (0, 1, 255):
        row = [int(v) for v in vals[i]]
        assert pfr.ints_from_words(got[i])[0] == pfr.hash_elements_host(pfr.pack_gl_host(row))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 4, 256, 512, 1 << 12, 1 << 15])
def test_poseidon_fr_merkle_levels_kernel_matches_plain(n):
    from eigen_zeth_tpu_torch.ops import poseidon_fr as pfr

    dev = _cuda()
    rng = np.random.default_rng(23)
    leaves = pfr.words_from_ints(
        [int.from_bytes(rng.bytes(32), "little") % pfr.R for _ in range(n)], dev)
    before = kernels.LAUNCHES["poseidon_fr"]
    got = kernels.poseidon_fr_merkle_levels(leaves)
    assert kernels.LAUNCHES["poseidon_fr"] == before + 1
    want = pfr.merkle_levels_fr_plain(leaves)
    assert len(got) == len(want) == n.bit_length() - 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    l0 = pfr.ints_from_words(leaves[:2])
    assert pfr.ints_from_words(got[0][:1]) == [pfr.hash_two_host(*l0)]


@pytest.mark.gpu
def test_poseidon_fr_grind_on_the_card_is_the_least_nonce():
    from eigen_zeth_tpu_torch.models.transcript_fr import TranscriptFr

    dev = _cuda()
    for bits in (0, 3, 8):
        for pad in range(0, 12):  # every lane the nonce and the label can land on
            a, b = TranscriptFr("g"), TranscriptFr("g")
            a.absorb("x", list(range(pad)))
            b.absorb("x", list(range(pad)))
            assert a.grind(bits, device=dev) == b.grind(bits, device="cpu")
            assert (a._state, a._pos) == (b._state, b._pos)
