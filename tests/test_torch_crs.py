"""The port's CRS files against the JAX package's.

For a small circuit (the MiMC wrap) under one seed, the port's `crs.save`
writes the arrays and the vk.json bytes that the JAX package's writes (an
.npz is a zip archive stamped with the time it was written, so its arrays
are compared, not its bytes); each package loads the other's files to the
same keys; a proving key held on the device (`DevicePoints`, here on CPU
tensors) encodes to the same arrays and proves the same proof through the
device MSM (`msm.msm_affine`); `shape_key` is the JAX one.
Tolerance: none.
"""

import numpy as np
import pytest
import torch

from eigen_zeth_tpu.models import crs as jcrs
from eigen_zeth_tpu.protocol import prover_service as jps
from eigen_zeth_tpu_torch import convert
from eigen_zeth_tpu_torch.models import crs, groth16, r1cs_builder
from eigen_zeth_tpu_torch.ops import bn254
from eigen_zeth_tpu_torch.ops import poseidon_fr

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker: the workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def keys():
    _, jpk, jvk = jps._wrap_crs("mimc", "ezt-groth16-dev")
    return convert.proving_key_from(jpk), convert.verifying_key_from(jvk), jpk, jvk


def _arrays(path):
    z = np.load(path / "pk.npz")
    return {k: z[k] for k in z.files}


def test_save_writes_the_jax_files(tmp_path, keys):
    pk, vk, jpk, jvk = keys
    crs.save(str(tmp_path / "port"), pk, vk)
    jcrs.save(str(tmp_path / "jax"), jpk, jvk)
    got, want = _arrays(tmp_path / "port"), _arrays(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert (tmp_path / "port" / "vk.json").read_bytes() == (tmp_path / "jax" / "vk.json").read_bytes()


def test_each_package_loads_the_other_files(tmp_path, keys):
    pk, vk, jpk, jvk = keys
    crs.save(str(tmp_path / "port"), pk, vk)
    jcrs.save(str(tmp_path / "jax"), jpk, jvk)
    lpk, lvk = crs.load(str(tmp_path / "jax"), device=CPU)
    assert vars(lpk) == vars(pk) and vars(lvk) == vars(vk)
    jlpk, jlvk = jcrs.load(str(tmp_path / "port"))
    assert vars(convert.proving_key_from(jlpk)) == vars(pk)
    assert vars(crs.load_pinned_vk(str(tmp_path / "jax"))) == vars(vk)
    assert crs.load(str(tmp_path / "missing"), device=CPU) is None


def test_device_points_encode_like_host_points(tmp_path, keys):
    pk, vk, _, _ = keys
    dev = {}
    for name, g2 in crs.QUERIES:
        pts = getattr(pk, name)
        F = bn254.Fq2Ops() if g2 else bn254.FqOps()
        ctx = F.fq.ctx if g2 else F.ctx
        inf = torch.tensor([p is None for p in pts])
        if g2:
            x = tuple(ctx.from_int([p[0][c] if p else 0 for p in pts], CPU) for c in (0, 1))
            y = tuple(ctx.from_int([p[1][c] if p else 0 for p in pts], CPU) for c in (0, 1))
        else:
            x = ctx.from_int([p[0] if p else 0 for p in pts], CPU)
            y = ctx.from_int([p[1] if p else 0 for p in pts], CPU)
        dev[name] = groth16.DevicePoints(x=x, y=y, inf=inf, g2=g2)
        assert dev[name].to_host() == pts
    dpk = groth16.ProvingKey(**{**vars(pk), **dev})
    crs.save(str(tmp_path / "dev"), dpk, vk)
    crs.save(str(tmp_path / "host"), pk, vk)
    got, want = _arrays(tmp_path / "dev"), _arrays(tmp_path / "host")
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_shape_key_equals_jax():
    for parts in (["a"], ["stark-wrap-final", "8", "4", "2", "32", "7", "0x11"]):
        assert crs.shape_key(parts) == jcrs.shape_key(parts)


def test_prove_with_device_queries_equals_host_queries():
    """Queries held as DevicePoints (here CPU tensors) go through
    `msm.msm_affine` and give the proof of the host tuples."""
    b = r1cs_builder.Builder()
    pub = b.witness_fr(3 ** 40 % poseidon_fr.R)
    acc = b.witness_fr(3)
    for _ in range(39):
        acc = b.fr_mul(acc, b.witness_fr(3))
    b.fr_assert_eq(acc, pub)
    r1cs, wit = b.finalize([1])
    pk, vk = groth16.setup(r1cs, seed="dev-points", device=CPU)
    def dev(points, g2):
        F = bn254.Fq2Ops() if g2 else bn254.FqOps()
        ctx = F.fq.ctx if g2 else F.ctx
        inf = torch.tensor([p is None for p in points])
        if g2:
            x = tuple(ctx.from_int([p[0][c] if p else 0 for p in points], CPU) for c in (0, 1))
            y = tuple(ctx.from_int([p[1][c] if p else 0 for p in points], CPU) for c in (0, 1))
        else:
            x = ctx.from_int([p[0] if p else 0 for p in points], CPU)
            y = ctx.from_int([p[1] if p else 0 for p in points], CPU)
        return groth16.DevicePoints(x=x, y=y, inf=inf, g2=g2)

    dpk = groth16.ProvingKey(**{**vars(pk), **{name: dev(getattr(pk, name), name == "b2_query")
                                         for name in ("a_query", "b1_query", "b2_query",
                                                      "l_query", "h_query")}})
    want = groth16.prove(pk, r1cs, wit, device=CPU)
    assert groth16.prove(dpk, r1cs, wit, device=CPU) == want
    assert groth16.verify(vk, want, [pub.value])


def test_pk_arrays_convert_to_the_port_key(tmp_path, keys):
    pk, vk, jpk, jvk = keys
    jcrs.save(str(tmp_path / "jax"), jpk, jvk)
    got = crs.proving_key_from_arrays(np.load(tmp_path / "jax" / "pk.npz"), device=CPU)
    assert vars(got) == vars(pk)
