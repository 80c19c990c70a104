"""The port's sound final wrap, `BatchProver(wrap="stark")`, on the CPU.

The tiny stark-wrap tier of tests/test_crs_lifecycle.py — 8-row chunk
traces, blowup 4 / 2 queries / terminal 32, 8 attestation queries, the
wrap profile at 2 queries, 4 grinding bits, blowup 8, two leaves,
SyntheticExecutor, blocks 1-2 — goes through the port's four steps on CPU
tensors, the CRS made by `ensure_wrap_crs` into a temporary directory.
The chunk proofs, the aggregated proof (two wrap-profile attestations),
the final proof and its public input must have the sha256 values of
tests/data/torch_stark_wrap_golden.json, which the JAX package produced
(`python tests/test_torch_stark_wrap.py` writes the file; about half an
hour on one CPU).  The final proof verifies under the pinned VK.  Marked
slow, as the JAX package's own test of this path is: the port's CPU run
takes tens of minutes too.  chip_smoke.py reproduces the same sha256 values
on the card.  Tolerance: none.
"""

import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
GOLDEN_PATH = REPO / "tests" / "data" / "torch_stark_wrap_golden.json"
CONFIG = {
    "executor": "SyntheticExecutor",
    "blocks": [1, 2],
    "chain_id": 12345,
    "stark_params": {"blowup": 4, "num_queries": 2, "terminal_size": 32},
    "chunk_trace_rows": 8,
    "agg_queries": 8,
    "wrap": "stark",
    "wrap_queries": 2,
    "wrap_grind_bits": 4,
    "wrap_blowup": 8,
    "max_wrap_leaves": 2,
    "groth16_seed": "ezt-groth16-dev",
    "aggregator_addr": "0x1111111111111111111111111111111111111111",
}


def _sha(s: str) -> str:
    return hashlib.sha256(s.encode()).hexdigest()


def prover_kwargs(crs_dir: str) -> dict:
    return dict(chunk_trace_rows=CONFIG["chunk_trace_rows"], agg_queries=CONFIG["agg_queries"],
                wrap="stark", wrap_queries=CONFIG["wrap_queries"],
                wrap_grind_bits=CONFIG["wrap_grind_bits"], wrap_blowup=CONFIG["wrap_blowup"],
                max_wrap_leaves=CONFIG["max_wrap_leaves"], groth16_seed=CONFIG["groth16_seed"],
                crs_dir=crs_dir)


def drive(prover) -> dict:
    """The four steps; the sha256 of what each returns."""
    blocks, chain = CONFIG["blocks"], CONFIG["chain_id"]
    r1 = prover.gen_batch_chunks("b", blocks, chain, "evm")
    r2 = prover.gen_chunk_proof("b", r1.task_id, r1.chunk_count, chain, "evm", r1.batch_data)
    r3 = prover.gen_aggregated_proof("b", r2.chunk_proofs[0].proof, r2.chunk_proofs[-1].proof)
    r4 = prover.gen_final_proof("b", r3.result_string, "BN128", CONFIG["aggregator_addr"])
    for r in (r1, r2, r3, r4):
        assert r.result_code == 0, r.error_message
    return {
        "chunk_proofs": [_sha(c.proof) for c in r2.chunk_proofs],
        "aggregated": _sha(r3.result_string),
        "final_proof": _sha(r4.final_proof.proof),
        "public_input": _sha(r4.final_proof.public_input),
    }, r4


@pytest.mark.slow
def test_port_stark_wrap_matches_the_golden_file(tmp_path):
    from eigen_zeth_tpu_torch.models import groth16, stark
    from eigen_zeth_tpu_torch.protocol import prover_service as ps

    golden = json.loads(GOLDEN_PATH.read_text())
    assert golden["config"] == CONFIG
    prover = ps.BatchProver(stark_params=stark.StarkParams(**CONFIG["stark_params"]),
                            device=torch.device("cpu"), **prover_kwargs(str(tmp_path / "crs")))
    prover.ensure_wrap_crs(CONFIG["aggregator_addr"])
    got, r4 = drive(prover)
    assert got == golden["sha256"]
    vk = prover.pinned_vk(CONFIG["aggregator_addr"])
    pub = [int(x) for x in json.loads(r4.final_proof.public_input)]
    assert groth16.verify(vk, json.loads(r4.final_proof.proof), pub)


def _write_golden(crs_dir: str) -> None:
    """Prove the tier with the JAX package and write the golden file."""
    from eigen_zeth_tpu.models import stark as jstark
    from eigen_zeth_tpu.protocol import prover_service as jps

    prover = jps.BatchProver(stark_params=jstark.StarkParams(**CONFIG["stark_params"]),
                             use_jit=False, **prover_kwargs(crs_dir))
    prover.ensure_wrap_crs(CONFIG["aggregator_addr"])
    sha, _ = drive(prover)
    GOLDEN_PATH.write_text(json.dumps({
        "config": CONFIG,
        "produced_by": "JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_stark_wrap.py "
                       "<scratch crs dir>",
        "sha256": sha,
    }, indent=1) + "\n")


if __name__ == "__main__":
    _write_golden(sys.argv[1])
