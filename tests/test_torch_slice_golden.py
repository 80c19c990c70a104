"""The golden file of the port's slice holds the JAX package's proofs.

tests/data/torch_slice_golden.json keeps the sha256 of each proof string of
the tiny MiMC slice — SyntheticExecutor, blocks 1-2, 16-row chunk traces,
blowup 4 / 2 queries / terminal 16, wrap="mimc", recursion off.  Here the
JAX `BatchProver(use_jit=False)` proves that slice on its numpy STARK path
(EZT_FORCE_NP_STARK=1) and each of its strings must hash to the golden
value; tests/test_torch_prover_service.py and chip_smoke.py hold the port to
the same values, so the port's strings are byte-identical to these.

The file's "recursion" entry keeps the same four values for the tiny
recursion tier (8-row chunk traces, blowup 4 / 2 queries / terminal 32, 8
queries of the attestation STARK, recursion on): the JAX prover attests the
first and last chunk with its verifier AIR and wraps the digest, and the
port is held to the same values.

This file runs the JAX side alone so that the test run can place it on
another worker than the port's side.  Tolerance: none (sha256 equality).
"""

import hashlib
import json
from pathlib import Path

import pytest

from eigen_zeth_tpu.models import stark as jstark
from eigen_zeth_tpu.protocol import prover_service as jps
from eigen_zeth_tpu.protocol.messages import ProofResultCode

GOLDEN = json.loads(
    (Path(__file__).resolve().parent / "data" / "torch_slice_golden.json").read_text()
)
CFG = GOLDEN["config"]


def _sha(s: str) -> str:
    return hashlib.sha256(s.encode()).hexdigest()


def _jax_slice(cfg, **extra):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EZT_FORCE_NP_STARK", "1")
        prover = jps.BatchProver(
            stark_params=jstark.StarkParams(**cfg["stark_params"]), wrap=cfg["wrap"],
            recursion=cfg["recursion"], use_jit=False, chunk_trace_rows=cfg["chunk_trace_rows"],
            groth16_seed=cfg["groth16_seed"], **extra,
        )
        r1 = prover.gen_batch_chunks("t", cfg["blocks"], cfg["chain_id"], "evm")
        r2 = prover.gen_chunk_proof("t", r1.task_id, r1.chunk_count, cfg["chain_id"], "evm",
                                    r1.batch_data)
        r3 = prover.gen_aggregated_proof("t", r2.chunk_proofs[0].proof, r2.chunk_proofs[-1].proof)
        r4 = prover.gen_final_proof("t", r3.result_string, "BN128", cfg["aggregator_addr"])
    for r in (r1, r2, r3, r4):
        assert r.result_code == ProofResultCode.COMPLETED_OK, r.error_message
    return {
        "chunk_proofs": [_sha(c.proof) for c in r2.chunk_proofs],
        "aggregated": _sha(r3.result_string),
        "final_proof": _sha(r4.final_proof.proof),
        "public_input": _sha(r4.final_proof.public_input),
    }


@pytest.fixture(scope="module")
def jax_slice():
    return _jax_slice(CFG)


@pytest.fixture(scope="module")
def jax_recursion_slice():
    cfg = GOLDEN["recursion"]["config"]
    return _jax_slice(cfg, agg_queries=cfg["agg_queries"])


@pytest.mark.parametrize("part", ["chunk_proofs", "aggregated", "final_proof", "public_input"])
def test_jax_slice_matches_the_golden_file(jax_slice, part):
    assert jax_slice[part] == GOLDEN["sha256"][part]


@pytest.mark.parametrize("part", ["chunk_proofs", "aggregated", "final_proof", "public_input"])
def test_jax_recursion_slice_matches_the_golden_file(jax_recursion_slice, part):
    assert jax_recursion_slice[part] == GOLDEN["recursion"]["sha256"][part]
