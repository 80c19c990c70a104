"""The port's KZG (setup, commit, open, verify) against the JAX package.

The fixture is the one of tests/test_kzg.py: a 16-point SRS from
tau = 0x5EED5EED, 8 coefficients and a point z drawn from seed 20260817.
tests/data/torch_kzg_golden.json keeps what the JAX package's `commit` and
`open_at` (run eagerly, z != 0 and z = 0) return on it.  Eager EC costs the
JAX CPU backend minutes per MSM, so the values are kept and not recomputed
here; run this file as a script to regenerate them with the JAX package:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_kzg.py

Here the kept values go back through the JAX package's host side (its
`verify`, and its host scalar multiplications as the naive commitment), the
port must reproduce them exactly, and each package's `verify` must judge
the other's outputs alike, the four tamper cases included.  The Fr helpers
(`_fr_powers`, the quotient) and the SRS meet the JAX functions directly.
Inputs come from numpy with a fixed seed.  Tolerance: none.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eigen_zeth_tpu.models import kzg as jkzg
from eigen_zeth_tpu.ops import bn254 as jbn
from eigen_zeth_tpu_torch import convert
from eigen_zeth_tpu_torch.models import kzg
from eigen_zeth_tpu_torch.ops import bn254, kernels

GOLDEN_PATH = Path(__file__).resolve().parent / "data" / "torch_kzg_golden.json"
R = bn254.R
TAU = 0x5EED5EED


def _fixture_inputs():
    rng = np.random.default_rng(20260817)
    draw = lambda n: [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]  # noqa: E731
    coeffs = draw(8)
    return coeffs, draw(1)[0]


def _point(p):
    return None if p is None else (int(p[0]), int(p[1]))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fx():
    """Both SRSs, the kept JAX outputs, and the port's commit and openings."""
    golden = json.loads(GOLDEN_PATH.read_text())
    coeffs, z = _fixture_inputs()
    jsrs = jkzg.setup_insecure(16, tau=TAU, device=False)
    srs = kzg.setup_insecure(16, TAU, "cpu")
    kernels.reset_launches()
    out = {
        "golden": {k: (_point(v) if isinstance(v, list) else int(v)) for k, v in golden["jax"].items()},
        "coeffs": coeffs, "z": z, "jsrs": jsrs, "srs": srs,
        "C": kzg.commit(srs, coeffs),
    }
    out["proof"], out["y"] = kzg.open_at(srs, coeffs, z)
    out["proof0"], out["y0"] = kzg.open_at(srs, coeffs, 0)
    assert not any(kernels.LAUNCHES.values())  # CPU tensors launch nothing
    return out


def test_srs_matches_jax_through_the_converter(fx):
    jsrs, srs = fx["jsrs"], fx["srs"]
    conv = convert.srs_from_jax(np.asarray(jsrs.g1_x), np.asarray(jsrs.g1_y),
                                np.asarray(jsrs.g1_inf), jsrs.g2_tau, "cpu")
    assert torch.equal(conv.g1_x, srs.g1_x) and torch.equal(conv.g1_y, srs.g1_y)
    assert torch.equal(conv.g1_inf, srs.g1_inf) and conv.g2_tau == srs.g2_tau
    assert conv.n == srs.n == 16 and srs.device == torch.device("cpu")
    assert srs.g1_points_host() == jsrs.g1_points_host()
    # both sides of the comparison can commit against the one converted SRS
    assert kzg.commit(conv, fx["coeffs"]) == fx["C"]


def test_setup_device_path_matches_host_path_and_jax():
    """The 254-step double-and-add sweep equals host scalar multiplications
    (66 points: above the 64 below which both packages stay on the host)."""
    tau = 0x1234ABCD
    host = kzg.setup_insecure(66, tau, "cpu", on_device=False)
    dev = kzg.setup_insecure(66, tau, "cpu")
    assert torch.equal(host.g1_x, dev.g1_x) and torch.equal(host.g1_y, dev.g1_y)
    assert torch.equal(host.g1_inf, dev.g1_inf) and host.g2_tau == dev.g2_tau
    jhost = jkzg.setup_insecure(66, tau, device=False)
    assert dev.g1_points_host() == jhost.g1_points_host() and dev.g2_tau == jhost.g2_tau


@pytest.mark.parametrize("n", [1, 8, 13])
def test_fr_powers_match_jax(n):
    base = _fixture_inputs()[1]
    want = np.asarray(jkzg._fr_powers(jkzg._fr(), base, n))
    got = kzg._fr_powers(kzg._fr(), base, n, "cpu")
    assert (convert.tensor_to_limbs(got) == want).all()


@pytest.mark.parametrize("n", [8, 13])
def test_quotient_matches_jax(n):
    """The log-depth suffix scan gives the field values of the JAX package's
    associative_scan, and both give synthetic division."""
    rng = np.random.default_rng(n)
    coeffs = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    z = _fixture_inputs()[1]
    frc, jfrc = kzg._fr(), jkzg._fr()
    zinv = pow(z, R - 2, R)
    args = (frc.from_int(coeffs, "cpu"), kzg._fr_powers(frc, z, n, "cpu"),
            frc.mont_mul(kzg._fr_powers(frc, zinv, n, "cpu"), frc.const_mont(zinv, (n,), "cpu")))
    q, y = kzg._quotient(*args)
    jq, jy = jkzg._quotient_jit(*(jnp.asarray(convert.tensor_to_limbs(a)) for a in args))
    assert (convert.tensor_to_limbs(q) == np.asarray(jq)).all()
    assert (convert.tensor_to_limbs(y) == np.asarray(jy)).all()
    # synthetic division: q_{n-1} = 0, q_{i-1} = c_i + z·q_i, p(z) = c_0 + z·q_0
    b, want = 0, []
    for c in reversed(coeffs):
        want.append(b)
        b = (c + z * b) % R
    assert [int(v) for v in frc.to_int(q)] == want[::-1] and int(frc.to_int(y)) == b
    assert int(jfrc.to_int(jy)) == b


def test_kept_jax_outputs_pass_the_jax_host_checks(fx):
    """What the file keeps is what the JAX package computes: its commitment is
    the naive Σ c_i·[τ^i]G1 (as tests/test_kzg.py holds for this fixture) and
    its own verify accepts both openings."""
    g, jsrs = fx["golden"], fx["jsrs"]
    naive = None
    for c, p in zip(fx["coeffs"], jsrs.g1_points_host()):
        naive = jbn.h_ec_add(naive, jbn.h_ec_mul(c, p))
    assert g["commit"] == naive
    assert jkzg.verify(jsrs, g["commit"], fx["z"], g["y"], g["proof"])
    assert jkzg.verify(jsrs, g["commit"], 0, g["y_at_0"], g["proof_at_0"])


@pytest.mark.parametrize("what", ["commit", "proof", "y", "proof_at_0", "y_at_0"])
def test_port_reproduces_the_jax_outputs(fx, what):
    mine = {"commit": fx["C"], "proof": fx["proof"], "y": fx["y"],
            "proof_at_0": fx["proof0"], "y_at_0": fx["y0"]}
    assert mine[what] == fx["golden"][what]


def test_open_values_match_horner(fx):
    acc = 0
    for c in reversed(fx["coeffs"]):
        acc = (acc * fx["z"] + c) % R
    assert fx["y"] == acc and fx["y0"] == fx["coeffs"][0] % R


def _tampered(fx, case):
    C, z, y, proof = fx["C"], fx["z"], fx["y"], fx["proof"]
    g1 = bn254.G1_GEN
    return {
        "roundtrip": (C, z, y, proof),
        "roundtrip_at_0": (C, 0, fx["y0"], fx["proof0"]),
        "wrong_value": (C, z, (y + 1) % R, proof),
        "tampered_commitment": (bn254.h_ec_add(C, g1), z, y, proof),
        "tampered_proof": (C, z, y, bn254.h_ec_add(proof, g1)),
        "wrong_point": (C, (z + 1) % R, y, proof),
    }[case]


@pytest.mark.parametrize("case", ["roundtrip", "roundtrip_at_0", "wrong_value",
                                  "tampered_commitment", "tampered_proof", "wrong_point"])
def test_verify_agrees_with_jax(fx, case):
    args = _tampered(fx, case)
    mine = kzg.verify(fx["srs"], *args)
    assert mine == jkzg.verify(fx["jsrs"], *args)
    assert mine == case.startswith("roundtrip")


def test_verify_zero_quotient():
    """A constant polynomial has the zero quotient: the proof is None and
    verify holds iff C == [y]G1."""
    srs = kzg.setup_insecure(4, TAU, "cpu")
    C = kzg.commit(srs, [7])
    proof, y = kzg.open_at(srs, [7], 5)
    assert proof is None and y == 7 and C == bn254.h_ec_mul(7, bn254.G1_GEN)
    assert kzg.verify(srs, C, 5, 7, None) and not kzg.verify(srs, C, 5, 8, None)


def _regenerate():
    """Recompute the kept values with the JAX package (minutes on a CPU)."""
    coeffs, z = _fixture_inputs()
    jsrs = jkzg.setup_insecure(16, tau=TAU, device=False)
    C = jkzg.commit(jsrs, coeffs, eager=True)
    proof, y = jkzg.open_at(jsrs, coeffs, z, eager=True)
    proof0, y0 = jkzg.open_at(jsrs, coeffs, 0, eager=True)
    doc = {
        "fixture": {"srs_points": 16, "tau": TAU, "coefficients": 8, "seed": 20260817,
                    "as": "tests/test_kzg.py"},
        "jax": {"commit": [str(v) for v in C], "proof": [str(v) for v in proof], "y": str(y),
                "proof_at_0": [str(v) for v in proof0], "y_at_0": str(y0)},
    }
    GOLDEN_PATH.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {GOLDEN_PATH}")


if __name__ == "__main__":
    _regenerate()
