"""The port's batch proof against the JAX package's, end to end.

The tiny MiMC slice — SyntheticExecutor, blocks 1-2, 16-row chunk traces,
blowup 4 / 2 queries / terminal 16, wrap="mimc", recursion off — runs
through the port's `BatchProver(device="cpu")`, which proves with the
device code on CPU tensors (the kernels' plain versions).  Steps 1-3 are
held byte for byte against the JAX `BatchProver(use_jit=False)` on its
numpy STARK path; the final proof, whose JAX side costs most of the time,
is held against tests/data/torch_slice_golden.json, and
tests/test_torch_slice_golden.py holds the JAX package's final proof to
the same file.  The port takes the JAX package's MiMC CRS through the
converters, so only one setup runs; a separate test holds the port's own
setup against the JAX one.

The tiny recursion tier is held to the JAX package the same way in
tests/test_torch_prover_recursion_tier.py (with the helpers here), and the
result codes of malformed input in tests/test_torch_prover_errors.py.

Tolerance: none — proof strings must be byte-identical (or have the
golden sha256).
"""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from eigen_zeth_tpu.models import groth16 as jgroth16
from eigen_zeth_tpu.models import stark as jstark
from eigen_zeth_tpu.protocol import prover_service as jps
from eigen_zeth_tpu_torch import convert
from eigen_zeth_tpu_torch.models import groth16, stark
from eigen_zeth_tpu_torch.protocol import prover_service as ps
from eigen_zeth_tpu_torch.protocol.messages import ProofResultCode

REPO = Path(__file__).resolve().parent.parent
GOLDEN = json.loads((REPO / "tests" / "data" / "torch_slice_golden.json").read_text())
CFG = GOLDEN["config"]
REC = GOLDEN["recursion"]
RCFG = REC["config"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run spreads files over several worker processes on the
    machine's cores; torch's own thread pool on top of that oversubscribes
    the cores and stalls every small op at its barrier.  One thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drive(prover, wrap_addr=CFG["aggregator_addr"]):
    r1 = prover.gen_batch_chunks("t", CFG["blocks"], CFG["chain_id"], "evm")
    r2 = prover.gen_chunk_proof("t", r1.task_id, r1.chunk_count, CFG["chain_id"], "evm", r1.batch_data)
    r3 = prover.gen_aggregated_proof("t", r2.chunk_proofs[0].proof, r2.chunk_proofs[-1].proof)
    r4 = prover.gen_final_proof("t", r3.result_string, "BN128", wrap_addr)
    for r in (r1, r2, r3, r4):
        assert r.result_code == ProofResultCode.COMPLETED_OK, r.error_message
    return r1, r2, r3, r4


def _jax_prover(wrap):
    return jps.BatchProver(
        stark_params=jstark.StarkParams(**CFG["stark_params"]), wrap=wrap, recursion=False,
        use_jit=False, chunk_trace_rows=CFG["chunk_trace_rows"],
    )


def _port_prover(wrap, crs=None):
    return ps.BatchProver(
        stark_params=stark.StarkParams(**CFG["stark_params"]), wrap=wrap, recursion=False,
        chunk_trace_rows=CFG["chunk_trace_rows"], crs=crs, device=torch.device("cpu"),
    )


def _recursion_provers():
    """(JAX, port) provers of the tiny recursion tier; recursion is left to
    each class's auto rule."""
    kw = dict(chunk_trace_rows=RCFG["chunk_trace_rows"], agg_queries=RCFG["agg_queries"],
              wrap=RCFG["wrap"])
    jprover = jps.BatchProver(stark_params=jstark.StarkParams(**RCFG["stark_params"]),
                              use_jit=False, **kw)
    prover = ps.BatchProver(stark_params=stark.StarkParams(**RCFG["stark_params"]),
                            crs=_jax_crs(RCFG["wrap"]), device=torch.device("cpu"), **kw)
    return jprover, prover


def _jax_crs(wrap):
    r1cs, pk, vk = jps._wrap_crs(wrap, CFG["groth16_seed"])
    return convert.r1cs_from(r1cs), convert.proving_key_from(pk), convert.verifying_key_from(vk)


@pytest.fixture(scope="module")
def slices():
    """(JAX steps 1-3, port steps 1-4)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EZT_FORCE_NP_STARK", "1")
        jprover = _jax_prover("mimc")
        w1 = jprover.gen_batch_chunks("t", CFG["blocks"], CFG["chain_id"], "evm")
        w2 = jprover.gen_chunk_proof("t", w1.task_id, w1.chunk_count, CFG["chain_id"], "evm",
                                     w1.batch_data)
        w3 = jprover.gen_aggregated_proof("t", w2.chunk_proofs[0].proof, w2.chunk_proofs[-1].proof)
    for r in (w1, w2, w3):
        assert r.result_code == ProofResultCode.COMPLETED_OK, r.error_message
    got = _drive(_port_prover("mimc", crs=_jax_crs("mimc")))
    return (w1, w2, w3), got


def _sha(s: str) -> str:
    return hashlib.sha256(s.encode()).hexdigest()


def test_steps_one_and_two_are_byte_identical(slices):
    (w1, w2, _), (g1, g2, _, _) = slices
    assert (g1.task_id, g1.chunk_count, g1.batch_data) == (w1.task_id, w1.chunk_count, w1.batch_data)
    assert g1.pre_state_root == w1.pre_state_root and g1.post_state_root == w1.post_state_root
    assert [c.proof for c in g2.chunk_proofs] == [c.proof for c in w2.chunk_proofs]
    assert [c.proof_key for c in g2.chunk_proofs] == [c.proof_key for c in w2.chunk_proofs]


def test_aggregated_digest_is_byte_identical(slices):
    (_, _, w3), (_, _, g3, _) = slices
    assert g3.result_string == w3.result_string


@pytest.mark.parametrize("part", ["chunk_proofs", "aggregated", "final_proof", "public_input"])
def test_port_slice_matches_the_golden_file(slices, part):
    _, (_, r2, r3, r4) = slices
    got = {
        "chunk_proofs": [_sha(c.proof) for c in r2.chunk_proofs],
        "aggregated": _sha(r3.result_string),
        "final_proof": _sha(r4.final_proof.proof),
        "public_input": _sha(r4.final_proof.public_input),
    }
    assert got[part] == GOLDEN["sha256"][part]


def test_final_proof_verifies_on_both_sides(slices):
    jprover_vk = jps._wrap_crs("mimc", CFG["groth16_seed"])[2]
    _, (_, _, _, g4) = slices
    proof = json.loads(g4.final_proof.proof)
    pub = [int(x) for x in json.loads(g4.final_proof.public_input)]
    assert jgroth16.verify(jprover_vk, proof, pub)
    assert groth16.verify(convert.verifying_key_from(jprover_vk), proof, pub)


def test_setup_matches_jax_on_the_linear_wrap():
    r1cs = groth16.wrap_circuit()
    pk, vk = groth16.setup(r1cs, seed="ezt-groth16-test", device=torch.device("cpu"))
    jpk, jvk = jgroth16.setup(jgroth16.wrap_circuit(), seed="ezt-groth16-test")
    assert pk == convert.proving_key_from(jpk)
    assert vk == convert.verifying_key_from(jvk)
    assert r1cs == convert.r1cs_from(jgroth16.wrap_circuit())


def test_linear_wrap_slice_matches_jax(monkeypatch):
    monkeypatch.setenv("EZT_FORCE_NP_STARK", "1")
    want = _drive(_jax_prover("linear"))
    got = _drive(_port_prover("linear"))
    assert got[3].final_proof.proof == want[3].final_proof.proof
    assert got[3].final_proof.public_input == want[3].final_proof.public_input
    assert got[2].result_string == want[2].result_string


def test_unported_settings_raise():
    """Every wrap of the JAX package is ported: an unknown wrap is refused,
    and a malformed wrap attestation is an error, not a silent pass."""
    for wrap in ("stark", "mimc", "linear"):
        assert ps.BatchProver(wrap=wrap, device=torch.device("cpu")).wrap == wrap
    with pytest.raises(ValueError, match="unknown wrap"):
        ps.BatchProver(wrap="plonk", device=torch.device("cpu"))
    prover = _port_prover("linear")
    with pytest.raises(KeyError):
        prover._validate({"type": "chunk-attested-wrap"})


@pytest.mark.parametrize("kw", [
    {},
    {"stark_params": {"blowup": 4, "num_queries": 2, "terminal_size": 32}, "chunk_trace_rows": 8},
    {"stark_params": {"blowup": 4, "num_queries": 30, "terminal_size": 64}},
    {"stark_params": {"blowup": 4, "num_queries": 2, "terminal_size": 16}, "chunk_trace_rows": 4},
    {"stark_params": {"blowup": 8, "num_queries": 2, "terminal_size": 16}},
    {"stark_params": {"blowup": 4, "num_queries": 4, "terminal_size": 16, "fri_arity": 4}},
    {"recursion": False},
    {"recursion": True, "chunk_trace_rows": 16},
], ids=["default", "tiny", "30-queries", "4-rows", "blowup-8", "arity-4", "off", "on-16-rows"])
def test_recursion_auto_rule_is_the_jax_one(kw):
    def make(mod, sp_cls, **extra):
        args = dict(kw)
        if "stark_params" in args:
            args["stark_params"] = sp_cls(**args["stark_params"])
        return mod.BatchProver(wrap="linear", **args, **extra)

    want = make(jps, jstark.StarkParams, use_jit=False)
    got = make(ps, stark.StarkParams, device=torch.device("cpu"))
    assert got.recursion == want.recursion
    assert got.chunk_trace_rows == want.chunk_trace_rows and got.chunk_elems == want.chunk_elems
    assert got.agg_queries == want.agg_queries == 30
    assert vars(got.stark_params) == vars(want.stark_params)


def test_recursion_needs_a_power_of_two_query_count():
    with pytest.raises(AssertionError, match="power-of-two"):
        ps.BatchProver(recursion=True, stark_params=stark.StarkParams(num_queries=30),
                       device=torch.device("cpu"))


def test_protocol_errors_are_results(slices):
    prover = _port_prover("linear")
    _, (_, r2, r3, _) = slices
    bad = json.loads(r2.chunk_proofs[0].proof)
    bad["stark"]["public"]["out"] = "1"
    res = prover.gen_aggregated_proof("t", json.dumps(bad), r2.chunk_proofs[1].proof)
    assert res.result_code == ProofResultCode.COMPLETED_ERROR
    res = prover.gen_final_proof("t", r3.result_string, "BLS12-381", CFG["aggregator_addr"])
    assert res.result_code == ProofResultCode.COMPLETED_ERROR
    assert prover.gen_batch_chunks("t", [], 1, "evm").result_code == ProofResultCode.COMPLETED_ERROR


def test_debug_proof_returns_the_reference_vectors(slices, monkeypatch):
    from eigen_zeth_tpu.protocol import vectors

    monkeypatch.setenv("DEBUG_PROOF", "TRUE")
    _, (_, _, r3, _) = slices
    res = _port_prover("linear").gen_final_proof("t", r3.result_string, "BN128", "0x00")
    assert json.loads(res.final_proof.proof) == vectors.reference_proof()
    assert json.loads(res.final_proof.public_input) == vectors.reference_public_input()


def test_port_never_imports_jax():
    """A fresh process imports every module of the port (the prover server,
    the state machine, the CLI among them) and chip_smoke.py's imports, and
    proves a 16-row chunk."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import eigen_zeth_tpu_torch as port\n"
        "names = [m.name for m in pkgutil.walk_packages(port.__path__, 'eigen_zeth_tpu_torch.')]\n"
        "assert {'eigen_zeth_tpu_torch.protocol.grpc_shim', 'eigen_zeth_tpu_torch.cli',\n"
        "        'eigen_zeth_tpu_torch.protocol.state_machine'} <= set(names), names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "from eigen_zeth_tpu_torch.models import stark\n"
        "p = stark.prove_chunk([1, 2, 3], 5, stark.StarkParams(num_queries=2, terminal_size=16),"
        " n_rows=16, device='cpu')\n"
        "assert stark.verify_chunk(p, stark.StarkParams(num_queries=2, terminal_size=16))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'eigen_zeth_tpu.'))]\n"
        "assert not bad and 'eigen_zeth_tpu' not in sys.modules, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
