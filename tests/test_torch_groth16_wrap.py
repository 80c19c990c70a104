"""The Groth16 parts of the port that the STARK wrap's circuit scale needs,
against the JAX package's.

  * setup and prove on a gadget-sized circuit (one Poseidon2-Fr
    permutation, about 500 constraints) under the same seeds: the proving
    and verifying keys and the proof JSON equal the JAX package's;
  * the device fixed-base (the window table gathered and reduced by a tree
    of point adds, here on CPU tensors through the kernels' plain
    versions) equals the JAX package's `_host_fixed_base` on 300 scalars,
    G1 and G2;
  * h's coefficients: the host NTTs and the device NTTs (the Fr MontCtx
    with the plain kernel A on the CPU) equal the JAX package's `_h_coeffs`
    on the MiMC wrap circuit, and the Lagrange basis at tau its
    `_lagrange_at`;
  * `host_pippenger` equals the JAX package's.
Tolerance: none.
"""

import numpy as np
import pytest
import torch

from eigen_zeth_tpu.models import groth16 as jg
from eigen_zeth_tpu.models import r1cs_builder as jrb
from eigen_zeth_tpu_torch import convert
from eigen_zeth_tpu_torch.models import groth16 as g
from eigen_zeth_tpu_torch.models import r1cs_builder
from eigen_zeth_tpu_torch.ops import poseidon_fr as pfr

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker: the workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gadget_circuit(builder):
    """One public input: the permutation's lane 0 of a witnessed state."""
    vals = [int(x) for x in np.random.default_rng(5).integers(0, 1 << 62, size=pfr.WIDTH)]
    pub = builder.witness_fr(pfr.perm_host(vals)[0])
    out = builder.poseidon_fr_perm([builder.witness_fr(v) for v in vals])
    builder.fr_assert_eq(out[0], pub)
    r1cs, wit = builder.finalize([1])
    return r1cs, wit, pub.value


@pytest.fixture(scope="module")
def gadget():
    r1cs, wit, pub = _gadget_circuit(r1cs_builder.Builder())
    jr1cs, jwit, jpub = _gadget_circuit(jrb.Builder())
    assert wit == jwit and pub == jpub and len(r1cs.constraints) == len(jr1cs.constraints)
    pk, vk = g.setup(r1cs, seed="gadget-seed", device=CPU)
    jpk, jvk = jg.setup(jr1cs, seed="gadget-seed")
    return r1cs, wit, pub, pk, vk, jr1cs, jpk, jvk


def test_gadget_setup_equals_jax(gadget):
    _, _, _, pk, vk, _, jpk, jvk = gadget
    assert vars(pk) == vars(convert.proving_key_from(jpk))
    assert vars(vk) == vars(convert.verifying_key_from(jvk))


def test_gadget_prove_equals_jax_and_verifies(gadget):
    r1cs, wit, pub, pk, vk, jr1cs, jpk, jvk = gadget
    proof = g.prove(pk, r1cs, wit, rng_seed="gadget-r", device=CPU)
    assert proof == jg.prove(jpk, jr1cs, wit, rng_seed="gadget-r", use_jit=False)
    assert g.verify(vk, proof, [pub]) and jg.verify(jvk, proof, [pub])
    forged = dict(proof, pi_c={"x": proof["pi_a"]["x"], "y": proof["pi_a"]["y"]})
    assert not g.verify(vk, forged, [pub])
    assert not g.verify(vk, proof, [(pub + 1) % pfr.R])


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_device_fixed_base_plain_equals_jax_host_fixed_base(g2):
    rng = np.random.default_rng(6 + g2)
    scalars = [int.from_bytes(rng.bytes(32), "little") for _ in range(300)]
    scalars[7] = 0
    scalars[8] = g.R  # 0 mod r
    scalars[9] = g.R - 1
    got = g.fixed_base_device(scalars, g2, CPU, chunk=128)
    assert isinstance(got, g.DevicePoints) and len(got) == 300
    assert got.to_host() == jg._host_fixed_base([s % g.R for s in scalars], g2)


def test_h_coeffs_host_and_device_forms_equal_jax():
    r1cs = g.mimc_wrap_circuit().r1cs
    w, _ = g.mimc_wrap_witness([1, 2, 3, 2**63])
    d = g._domain_size(len(r1cs.constraints))
    want = jg._h_coeffs(jg.mimc_wrap_circuit().r1cs, w, d)
    assert g._h_coeffs(r1cs, w, d) == want
    assert g._h_from_values_device(*g._row_values(r1cs, w), d, CPU) == want
    bad = list(w)
    bad[7] = (bad[7] + 1) % g.R
    with pytest.raises(AssertionError, match="unsatisfied"):
        g._row_values(r1cs, bad)
    assert g._lagrange_at(987654321, 256) == jg._lagrange_at(987654321, 256)


def test_host_pippenger_equals_jax():
    rng = np.random.default_rng(8)
    pts = g.batch_fixed_base([int(v) for v in rng.integers(1, 2**40, 40)], device=CPU)
    sc = [int.from_bytes(rng.bytes(32), "little") % g.R for _ in range(40)]
    assert g.host_pippenger(pts, sc, c=5) == jg.host_pippenger(pts, sc, c=5)
    g2 = g.batch_fixed_base([int(v) for v in rng.integers(1, 2**40, 12)], g2=True,
                            device=CPU)
    assert g.host_pippenger(g2, sc[:12], g2=True, c=4) == jg.host_pippenger(g2, sc[:12], g2=True,
                                                                              c=4)



def test_device_forms_of_lagrange_and_h_scalars_equal_host():
    """The setup's Lagrange basis and prove's h as the MSM's limbs, made
    on the device (here CPU tensors), equal the host values."""
    assert g._lagrange_at_device(987654321, 64, CPU) == g._lagrange_at(987654321, 64)
    r1cs = g.wrap_circuit()
    w, _ = g.wrap_witness([5, 6, 7, 8])
    d = g._domain_size(len(r1cs.constraints))
    rows = g._row_values(r1cs, w)
    limbs = g._h_from_values_device(*rows, d, CPU, as_scalars=True)
    from eigen_zeth_tpu_torch.ops import msm

    assert torch.equal(limbs, msm._limbs_tensor(g._h_from_values(*rows, d), CPU))


def test_passes_over_constraints_in_worker_processes_equal_one_process(monkeypatch, gadget):
    """The row values at the witness and the sums at tau, split over forked
    worker processes, equal the single-process pass."""
    r1cs, wit, _, pk, vk, _, _, _ = gadget
    want_rows = g._row_values(r1cs, wit)
    monkeypatch.setattr(g, "PARALLEL_MIN", 16)
    monkeypatch.setattr(g, "HOST_WORKERS", 3)
    assert g._row_values(r1cs, wit) == want_rows
    pk2, vk2 = g.setup(r1cs, seed="gadget-seed", device=CPU)
    assert vars(pk2) == vars(pk) and vars(vk2) == vars(vk)
