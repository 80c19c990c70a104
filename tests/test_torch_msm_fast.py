"""The port's fast G1 MSM against the JAX package, on the CPU.

Kernel C's plain version is held against `msm._scan_step` (its XLA mirror
branch, which the JAX package's own CPU tests run) and kernel D's against
`bn254.point_madd_unsafe`; the signed digits against the JAX function; the
entry points against the JAX package's host Pippenger.  The fast window
sums meet the JAX package's in tests/test_torch_msm_fast_jax.py, and
tests/test_torch_kernels_gpu.py holds the CUDA kernels against the same
plain versions on the card.  Inputs come from numpy with a fixed seed.
Tolerance: none, exact integer equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eigen_zeth_tpu.models import groth16 as jgroth16
from eigen_zeth_tpu.ops import bn254 as jbn
from eigen_zeth_tpu.ops import msm as jmsm
from eigen_zeth_tpu_torch import convert
from eigen_zeth_tpu_torch.ops import bn254, kernels, msm

RNG = np.random.default_rng(0xFA57)
Q, R = bn254.Q, bn254.R
CTX = bn254.fq()


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


def _same(got: torch.Tensor, want) -> bool:
    return bool((convert.tensor_to_limbs(got) == np.asarray(want)).all())


# ---------------------------------------------------------------------------
# kernels C and D: the plain versions against the XLA mirrors


def _step_batch(n=64):
    """acc (x, y, z), point (x, y), sign, flag as host lists; the first slots
    are the edge cases, the rest random field elements (the formulas are
    algebraic, so any canonical values serve)."""
    pts = [jbn.h_ec_mul(k, jbn.G1_GEN) for k in range(1, 5)]
    neg = lambda p: (p[0], (-p[1]) % Q)  # noqa: E731
    P = pts[0]
    edge = [
        # acc, point, sign, flag
        ((0, 0, 0), pts[1], 0, 1),          # all-zero accumulator under a flag
        ((0, 0, 0), pts[1], 1, 1),          # ... with the sign set
        (P + (1,), P, 0, 0),                # P + P: H == 0, bad
        (P + (1,), neg(P), 0, 0),           # P + (-P): H == 0, bad
        (P + (1,), P, 1, 0),                # sign turns P into -P: still H == 0
        (pts[2] + (0,), pts[3], 0, 0),      # accumulator at infinity: bad
        (P + (1,), P, 0, 1),                # the same three under a flag: not bad
        (P + (1,), neg(P), 0, 1),
        (pts[2] + (0,), pts[3], 1, 1),
        (pts[2] + (1,), (pts[3][0], 0), 1, 0),   # y = 0 and sign set: -0 = 0
        (pts[2] + (1,), (pts[3][0], 0), 1, 1),   # ... visible in y' under a flag
        (pts[0] + (1,), pts[1], 0, 0),      # an honest add, sign clear
        (pts[0] + (1,), pts[1], 1, 0),      # ... and sign set
    ]
    m = n - len(edge)
    cols = [[e[0][k] for e in edge] + _rand_ints(m, Q) for k in range(3)]
    cols += [[e[1][k] for e in edge] + _rand_ints(m, Q) for k in range(2)]
    sgn = [e[2] for e in edge] + [int(b) for b in RNG.integers(0, 2, m)]
    flg = [e[3] for e in edge] + [int(b) for b in RNG.integers(0, 2, m)]
    return cols, sgn, flg, len(edge)


def test_scan_step_plain_matches_xla_mirror():
    cols, sgn, flg, n_edge = _step_batch()
    ax, ay, az, bx, by = (CTX.from_int(c, "cpu") for c in cols)
    ts, tf = torch.tensor(sgn, dtype=torch.int32), torch.tensor(flg, dtype=torch.int32)
    want, want_bad = jmsm._scan_step(
        jbn.FqOps(), jbn.PointJ(_j(ax), _j(ay), _j(az)), _j(bx), _j(by),
        jnp.asarray(np.array(sgn, bool)), jnp.asarray(np.array(flg, bool)),
    )
    got = kernels.point_scan_step_plain(CTX, (ax, ay, az), (bx, by), ts, tf)
    for g, w in zip(got[:3], want):
        assert _same(g, w)
    assert got[3].dtype == torch.int32
    assert (got[3].numpy() == np.asarray(want_bad).astype(np.int32)).all()
    # the edge cases mean what they should
    assert got[3][:n_edge].tolist() == [0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
    one = CTX.one_mont((1,), "cpu")[:, 0]
    assert torch.equal(got[2][:, 0], one) and torch.equal(got[2][:, 1], one)
    assert int(got[1][:, 10].abs().sum()) == 0  # y = 0 stays the canonical 0
    # the dispatching entry points take the plain version for CPU tensors
    for g, w in zip(kernels.point_scan_step(CTX, (ax, ay, az), (bx, by), ts, tf), got):
        assert torch.equal(g, w)
    shaped = lambda t: t.reshape(16, 8, 8)  # noqa: E731
    out, bad = msm._scan_step(
        bn254.FqOps(), bn254.PointJ(shaped(ax), shaped(ay), shaped(az)), shaped(bx), shaped(by),
        ts.reshape(8, 8) != 0, tf.reshape(8, 8) != 0,
    )
    assert all(torch.equal(o.reshape(16, -1), g) for o, g in zip(out, got[:3]))
    assert bad.dtype == torch.bool and torch.equal(bad.reshape(-1), got[3] != 0)
    # the honest adds are the curve's: P1 + P2 and P1 - P2
    F = bn254.FqOps()
    ax_, ay_ = bn254.to_affine(F, bn254.PointJ(*(t[:, 11:13] for t in got[:3])))
    p1, p2 = jbn.h_ec_mul(1, jbn.G1_GEN), jbn.h_ec_mul(2, jbn.G1_GEN)
    have = list(zip(map(int, CTX.to_int(ax_)), map(int, CTX.to_int(ay_))))
    assert have == [jbn.h_ec_add(p1, p2), jbn.h_ec_add(p1, (p2[0], (-p2[1]) % Q))]


def test_point_madd_plain_matches_xla_mirror():
    cols, _, _, _ = _step_batch()
    ax, ay, az, bx, by = (CTX.from_int(c, "cpu") for c in cols)
    want, want_bad = jbn.point_madd_unsafe(
        jbn.FqOps(), jbn.PointJ(_j(ax), _j(ay), _j(az)), _j(bx), _j(by)
    )
    got = kernels.point_madd_plain(CTX, (ax, ay, az), (bx, by))
    for g, w in zip(got[:3], want):
        assert _same(g, w)
    assert (got[3].numpy() == np.asarray(want_bad).astype(np.int32)).all()
    # bad is not masked here: the flagged slots of the batch count too
    assert got[3][:13].tolist() == [1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0]
    for g, w in zip(kernels.point_madd(CTX, (ax, ay, az), (bx, by)), got):
        assert torch.equal(g, w)
    out, bad = bn254.point_madd_unsafe(bn254.FqOps(), bn254.PointJ(ax, ay, az), bx, by)
    assert all(torch.equal(o, g) for o, g in zip(out, got[:3]))
    assert bad.dtype == torch.bool and torch.equal(bad, got[3] != 0)


def test_point_neg_matches_jax():
    cols, _, _, _ = _step_batch(16)
    ax, ay, az = (CTX.from_int(c, "cpu") for c in cols[:3])
    want = jbn.point_neg(jbn.FqOps(), jbn.PointJ(_j(ax), _j(ay), _j(az)))
    got = bn254.point_neg(bn254.FqOps(), bn254.PointJ(ax, ay, az))
    assert all(_same(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# signed digits


@pytest.mark.parametrize("c", [4, 8, 13, 16])
def test_signed_digits_match_jax_and_rebuild_the_scalar(c):
    sc = [0, 1, R - 1] + _rand_ints(29, R)
    limbs = msm.scalar_limbs(sc)
    want_mag, want_sign = jmsm.signed_digits_from_limbs(jnp.asarray(limbs), c=c)
    mag, sign = msm.signed_digits_from_limbs(torch.from_numpy(limbs.astype(np.int64)), c=c)
    assert mag.dtype == torch.int64 and sign.dtype == torch.bool
    assert (mag.numpy() == np.asarray(want_mag)).all()
    assert (sign.numpy() == np.asarray(want_sign)).all()
    assert int(mag.max()) <= 1 << (c - 1) and not bool((sign & (mag == 0)).any())
    for i, s in enumerate(sc):
        rebuilt = sum((-1 if sign[w, i] else 1) * int(mag[w, i]) << (c * w)
                      for w in range(mag.shape[0]))
        assert rebuilt == s


# ---------------------------------------------------------------------------
# entry points against the host oracle


def _instance(n, scalars=None):
    ks = [int(k) for k in RNG.integers(1, 2**62, n)]
    pts = [jbn.h_ec_mul_jac(k, jbn.G1_GEN) for k in ks]
    return pts, scalars or _rand_ints(n, R)


def _coords(pts):
    xs = CTX.from_int([p[0] if p else 0 for p in pts], "cpu")
    ys = CTX.from_int([p[1] if p else 0 for p in pts], "cpu")
    return xs, ys, torch.tensor([p is None for p in pts])


def test_two_infinities_raise_bad():
    """Infinities take digit 0 and coordinates (0, 0); the stable sort leaves
    two of them side by side in bucket 0, where H == 0."""
    F = bn254.FqOps()
    pts, sc = _instance(16)
    pts[3] = pts[11] = None
    xs, ys, inf = _coords(pts)
    mag, sign = msm.signed_digits_from_limbs(msm._limbs_tensor(sc, "cpu"), c=4)
    _, bad = msm.g1_window_sums_fast(F, xs, ys, inf, mag, sign, c=4, serial=4)
    assert bool(bad)
    assert msm.msm_g1_fast(pts, sc, c=4, serial=4, device="cpu") == jgroth16.host_pippenger(pts, sc)
    # one infinity alone does not collide
    pts[11] = jbn.h_ec_mul(77, jbn.G1_GEN)
    xs, ys, inf = _coords(pts)
    _, bad = msm.g1_window_sums_fast(F, xs, ys, inf, mag, sign, c=4, serial=4)
    assert not bool(bad)


@pytest.mark.parametrize("n,c,serial", [(13, 4, 32), (40, 8, 8)])
def test_msm_g1_fast_matches_host_pippenger(n, c, serial):
    pts, sc = _instance(n)
    sc[0], sc[1], sc[2] = 0, 1, R - 1
    assert msm.msm_g1_fast(pts, sc, c=c, serial=serial, device="cpu") == \
        jgroth16.host_pippenger(pts, sc)


def test_msm_g1_device_matches_host_pippenger():
    pts, sc = _instance(24)
    xs, ys, inf = _coords(pts)
    assert msm.msm_g1_device(xs, ys, inf, sc) == jgroth16.host_pippenger(pts, sc)
    # a collision (the same point twice under one scalar) goes through the fallback
    pts[7], sc[7] = pts[6], sc[6]
    xs, ys, inf = _coords(pts)
    assert msm.msm_g1_device(xs, ys, inf, sc, c=4) == jgroth16.host_pippenger(pts, sc)


@pytest.mark.parametrize("entry", ["fast", "device", "table"])
def test_zero_result(entry):
    """s·P + (r - s)·P is the point at infinity: None."""
    s = _rand_ints(1, R)[0]
    pts, sc = [jbn.G1_GEN, jbn.h_ec_mul(5, jbn.G1_GEN)], [5 * s % R, R - s]
    if entry == "fast":
        got = msm.msm_g1_fast(pts, sc, c=4, device="cpu")
    elif entry == "device":
        got = msm.msm_g1_device(*_coords(pts), sc)
    else:
        got = msm.msm_g1_table(msm.g1_build_table(pts, c=4, device="cpu"), sc, serial=2)
    assert got is None


def test_msm_g1_table_matches_host_pippenger():
    pts, sc = _instance(6)
    sc[2] = 0
    table = msm.g1_build_table(pts, c=8, device="cpu")
    assert table.n_windows == 32 and table.txs.shape == (16, 32 * 6)
    # slab w holds 2^(cw)·P_i
    F = bn254.FqOps()
    host = msm.host_points(F, table.txs, table.tys, table.tinf)
    assert host[6:12] == [jbn.h_ec_mul_jac(1 << 8, p) for p in pts]
    assert msm.msm_g1_table(table, sc, serial=8) == jgroth16.host_pippenger(pts, sc)
    # the JAX package's table fields, through the converter, serve the same query
    jt = jmsm.g1_build_table(pts, c=8, eager=True)
    conv = convert.g1_table_from_jax(np.asarray(jt.txs), np.asarray(jt.tys), np.asarray(jt.tinf),
                                     jt.c, jt.n, "cpu")
    assert torch.equal(conv.txs, table.txs) and torch.equal(conv.tys, table.tys)
    assert torch.equal(conv.tinf, table.tinf) and (conv.c, conv.n) == (table.c, table.n)


def test_gen_test_points_match_jax_seed_and_dlogs():
    """The same seed gives the JAX package's discrete logs, and the points
    are those multiples of the generator."""
    xs, ys, dlogs = msm.gen_test_points(4, seed=5, device="cpu")
    rng = np.random.default_rng(5)
    ka = [int(x) for x in rng.integers(1, 1 << 60, size=4, dtype=np.int64)]
    kb = [int(x) << 61 for x in rng.integers(1, 1 << 60, size=4, dtype=np.int64)]
    assert dlogs == [a + b for a in ka for b in kb] and len(set(dlogs)) == 16
    have = list(zip(map(int, CTX.to_int(xs)), map(int, CTX.to_int(ys))))
    assert have == [jbn.h_ec_mul_jac(k, jbn.G1_GEN) for k in dlogs]
