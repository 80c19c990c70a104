"""The port's fast G1 window sums against the JAX package's, on the CPU.

`msm.g1_window_sums_fast` of both packages takes the same points and the
same signed digits; the affine window sums, their infinity mask and `bad`
must be equal.  Inputs come from numpy with a fixed seed.  Tolerance: none,
exact integer equality.

Eager EC ops cost the JAX CPU backend seconds each whatever their width,
so this file holds the JAX side of the comparison apart from the port's
other MSM tests (tests/test_torch_msm_fast.py), runs two instances only, at
12 and 8 points, and hands the JAX side a few of the 64 windows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eigen_zeth_tpu.models import groth16 as jgroth16
from eigen_zeth_tpu.ops import bn254 as jbn
from eigen_zeth_tpu.ops import msm as jmsm
from eigen_zeth_tpu_torch import convert
from eigen_zeth_tpu_torch.ops import bn254, msm

RNG = np.random.default_rng(0xFA58)
R = bn254.R
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


def _instance(n, scalars=None):
    ks = [int(k) for k in RNG.integers(1, 2**62, n)]
    pts = [jbn.h_ec_mul_jac(k, jbn.G1_GEN) for k in ks]
    return pts, scalars or _rand_ints(n, R)


def _coords(pts):
    xs = CTX.from_int([p[0] if p else 0 for p in pts], "cpu")
    ys = CTX.from_int([p[1] if p else 0 for p in pts], "cpu")
    return xs, ys, torch.tensor([p is None for p in pts])


def _both_window_sums(pts, sc, c, serial, windows):
    """The port's window sums over all windows, and the JAX package's over
    the listed ones; each as (affine x, affine y, infinity mask, bad), made
    affine by the port's to_affine."""
    F = bn254.FqOps()
    xs, ys, inf = _coords(pts)
    limbs = msm.scalar_limbs(sc)
    mag, sign = msm.signed_digits_from_limbs(torch.from_numpy(limbs.astype(np.int64)), c=c)
    S, bad = msm.g1_window_sums_fast(F, xs, ys, inf, mag, sign, c=c, serial=serial)
    jmag, jsign = jmsm.signed_digits_from_limbs(jnp.asarray(limbs), c=c)
    pick = np.array(windows)
    jS, jbad = jmsm.g1_window_sums_fast(
        jbn.FqOps(), _j(xs), _j(ys), jnp.asarray(inf.numpy()), jmag[pick], jsign[pick], c=c,
        serial=serial, eager=True,
    )
    jS = bn254.PointJ(*(convert.limbs_to_tensor(np.asarray(t), "cpu") for t in jS))
    port = (*bn254.to_affine(F, S), F.is_zero(S.z), bool(bad))
    ref = (*bn254.to_affine(F, jS), F.is_zero(jS.z), bool(np.asarray(jbad)))
    return port, ref


def test_window_sums_match_jax_when_serial_does_not_divide_n():
    """12 distinct points, c = 4, serial 8: the depth halves to 4, 3 lanes.
    The JAX side computes the two lowest windows and the two highest."""
    pts, sc = _instance(12)
    sc[0], sc[1], sc[2] = 0, 1, R - 1
    windows = [0, 1, 62, 63]
    port, ref = _both_window_sums(pts, sc, c=4, serial=8, windows=windows)
    assert port[3] is False and ref[3] is False
    for g, w in zip(port[:3], ref[:3]):
        assert torch.equal(g[..., windows], w)
    # and they are the MSM's window sums: Horner over them gives the oracle
    xs, ys = CTX.to_int(port[0]), CTX.to_int(port[1])
    assert msm._host_horner(msm._affine_windows(xs, ys, port[2].numpy()), 4) == \
        jgroth16.host_pippenger(pts, sc)


def test_duplicated_point_raises_bad_on_both_sides():
    """Two copies of one point with one scalar sit side by side in a bucket:
    the unsafe add meets P == Q.  The fast entry point still returns the
    oracle's point, through the complete-add schedule."""
    pts, sc = _instance(8)
    pts[5], sc[5] = pts[4], sc[4]
    port, ref = _both_window_sums(pts, sc, c=4, serial=4, windows=[0, 1])
    assert port[3] is True and ref[3] is True
    assert msm.msm_g1_fast(pts, sc, c=4, serial=4, device="cpu") == jgroth16.host_pippenger(pts, sc)
