"""The port's multi-device layer against the JAX package: the four-step NTT,
the mesh, the domain-sharded NTT and the distributed MSM, on CPU shards (a
device repeated: logical shards, one controller).  The chunk axis and the
driver's entry points are in tests/test_torch_dryrun.py.

- `ntt_four_step` / `intt_four_step`, `ntt_auto` and `poly_mul` against the
  JAX package's `ntt`, `ntt_four_step` and `poly_mul` at n = 256 and 1,024.
- `ntt_sharded` over 2, 4 and 8 shards against the JAX `ntt`, and the
  round trip through `intt_sharded`.
- `msm_dist_int_mock` against numpy; `msm_dist_g1` on a handful of points
  against the host's scalar multiplications; `msm.msm` likewise; the
  shards' pairwise tree refusing a shard count that is not a power of two.
The JAX package's shard_map paths are not run (tests/test_parallel.py does).
Tolerance: none, exact integer and byte equality.
"""

import numpy as np
import pytest
import torch

from eigen_zeth_tpu.ops import goldilocks as jgl
from eigen_zeth_tpu.ops import ntt as jntt
from eigen_zeth_tpu_torch.ops import bn254, msm
from eigen_zeth_tpu_torch.ops import goldilocks as gl
from eigen_zeth_tpu_torch.ops import ntt
from eigen_zeth_tpu_torch.parallel import mesh, msm_dist, ntt_dist

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker: the workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n_domain, n_chunk=1):
    return mesh.make_mesh(n_domain, n_chunk, devices=[CPU] * (n_domain * n_chunk))


def values(n, seed):
    return np.random.default_rng(seed).integers(0, gl.P, n, dtype=np.uint64)


def jax_ntt(v, inverse=False):
    return jgl.to_int((jntt.intt if inverse else jntt.ntt)(jgl.from_int(v)))


@pytest.mark.parametrize("n", [256, 1024])
def test_four_step_auto_and_poly_mul_equal_jax(n, monkeypatch):
    v = values(n, n)
    x = gl.from_int(v, CPU)
    want = jax_ntt(v)
    rows = 1 << ((n.bit_length() - 1) // 2)
    if n == 256:
        jplan = jntt.make_four_step_plan(n, rows)
        assert (jgl.to_int(jntt.ntt_four_step(jgl.from_int(v), jplan)) == want).all()
    for r in (rows, 2 * rows):
        got = ntt.ntt_four_step(x, ntt.make_four_step_plan(n, r, False, CPU))
        assert (gl.to_int(got) == want).all()
        back = ntt.intt_four_step(got, ntt.make_four_step_plan(n, r, True, CPU))
        assert (gl.to_int(back) == v).all()
    # ntt_auto takes the four-step plan from FOUR_STEP_MIN up: force it here
    monkeypatch.setattr(ntt, "FOUR_STEP_MIN", n)
    assert (gl.to_int(ntt.ntt_auto(x)) == want).all()
    assert (gl.to_int(ntt.intt_auto(x)) == jax_ntt(v, inverse=True)).all()
    a, b = values(n // 2, 1), values(n // 4 + 3, 2)
    got = ntt.poly_mul(gl.from_int(a, CPU), gl.from_int(b, CPU))
    assert (gl.to_int(got) == jgl.to_int(jntt.poly_mul(jgl.from_int(a), jgl.from_int(b)))).all()


def test_mesh_shapes_and_limits():
    m = mesh.make_mesh(4, 2, devices=[CPU] * 8)
    assert m.shape == {mesh.CHUNK_AXIS: 2, mesh.DOMAIN_AXIS: 4}
    assert len(m.domain_devices(1)) == 4 and len(m.chunk_devices(3)) == 2
    assert mesh.make_mesh(devices=[CPU] * 6, n_chunk=2).shape[mesh.DOMAIN_AXIS] == 3
    with pytest.raises(ValueError, match="need 2 x 4 devices, have 4"):
        mesh.make_mesh(4, 2, devices=[CPU] * 4)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_ntt_sharded_equal_jax_and_round_trip(d):
    n, rows = 1024, 32
    v = values(n, d)
    m = cpu_mesh(d)
    shards = ntt_dist.ntt_sharded(gl.from_int(v, CPU), m, rows=rows)
    assert len(shards) == d and all(s.shape == (n // d,) for s in shards)
    assert (gl.to_int(torch.cat(shards)) == jax_ntt(v)).all()
    back = ntt_dist.intt_sharded(shards, m, rows=rows)
    assert (gl.to_int(torch.cat(back)) == v).all()
    with pytest.raises(ValueError, match="divide"):
        ntt_dist.ntt_sharded(gl.from_int(v[:16], CPU), cpu_mesh(8), rows=2)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_msm_dist_int_mock_equal_numpy(d):
    rng = np.random.default_rng(40 + d)
    n = 256
    vals = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    scalars = rng.integers(0, 1 << 31, size=n, dtype=np.uint64)
    digits = torch.from_numpy(msm.scalar_digits([int(s) for s in scalars], c=4,
                                                nbits=32).astype(np.int64))
    got = msm_dist.msm_dist_int_mock(cpu_mesh(d), torch.from_numpy(vals.astype(np.int64)),
                                     digits, c=4)
    assert got == int((vals * scalars).sum() % (1 << 32))


@pytest.mark.parametrize("d", [1, 2, 3, 4, 6])
def test_allreduce_group_needs_a_power_of_two_shard_count(d):
    """The pairwise tree over 3 or 6 shards raises, where the JAX package's
    tree drops the odd shard's sums without a word; over 1, 2 or 4 it is
    the group sum."""
    vals = [torch.tensor([[7 * k + 1, 1 << 31]], dtype=torch.int64) for k in range(d)]
    if d & (d - 1):
        with pytest.raises(ValueError, match="power-of-two"):
            msm_dist._allreduce_group(msm.IntGroup(), vals, CPU)
        return
    got = msm_dist._allreduce_group(msm.IntGroup(), vals, CPU)
    want = [sum(7 * k + 1 for k in range(d)) & 0xFFFFFFFF, (d << 31) & 0xFFFFFFFF]
    assert got.tolist() == [want]


def test_msm_dist_g1_equal_host():
    """8 points with known logs, 8-bit scalars (two windows of c = 4)."""
    rng = np.random.default_rng(7)
    logs = [int(k) for k in rng.integers(1, 1 << 60, 8)]
    scalars = [int(s) for s in rng.integers(0, 1 << 8, 8)]
    scalars[3] = 0
    pts = [bn254.h_ec_mul_jac_f(k, bn254.G1_GEN) for k in logs]
    pts[5] = None  # the identity among them
    F = bn254.FqOps()
    P = msm._g1_device_points(pts, CPU)
    digits = msm.digits_from_limbs(msm._limbs_tensor(scalars, CPU), 4, nbits=8)
    total = sum(s * k for i, (s, k) in enumerate(zip(scalars, logs)) if i != 5) % bn254.R
    want = bn254.h_ec_mul_jac_f(total, bn254.G1_GEN)
    for out in (msm_dist.msm_dist_g1(P, digits, cpu_mesh(2), c=4), msm.msm(F, P, digits, c=4)):
        ax, ay = bn254.to_affine(F, out)
        assert (int(F.to_int(ax)), int(F.to_int(ay))) == want
