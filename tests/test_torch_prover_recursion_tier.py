"""The port's recursion tier against the JAX package's, end to end.

The tiny recursion tier — 8-row chunk traces, blowup 4 / 2 queries /
terminal 32 (zero-layer child FRI), 8 queries of the attestation STARK,
wrap="mimc", recursion on — goes through the port's
`BatchProver(device="cpu")`: step 1 against the JAX `BatchProver`'s, the
chunk proofs, the aggregated proof (the two attestation STARKs) and the
final proof against the golden file's "recursion" entry, the sha256 of
the JAX package's strings, which tests/test_torch_slice_golden.py holds
the JAX package to.  Split from tests/test_torch_prover_service.py
(whose helpers it uses) to keep each file's time down.

Tolerance: none — proof strings must be byte-identical (or have the
golden sha256).
"""

import json

import pytest
import torch

from eigen_zeth_tpu_torch.ops import goldilocks as gl
from eigen_zeth_tpu_torch.protocol.messages import ProofResultCode
from test_torch_prover_service import REC, RCFG, _recursion_provers, _sha


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker: the workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def recursion_slices():
    """(JAX step 1, port steps 1-4) of the tiny recursion tier.  The JAX
    package's steps 2 and 3 are held to the golden file's sha256 by
    tests/test_torch_slice_golden.py, so the port's are held to the same
    values here instead of being proved by the JAX package a second time."""
    jprover, prover = _recursion_provers()
    assert jprover.recursion and prover.recursion
    blocks, chain = RCFG["blocks"], RCFG["chain_id"]
    w1 = jprover.gen_batch_chunks("t", blocks, chain, "evm")
    g1 = prover.gen_batch_chunks("t", blocks, chain, "evm")
    g2 = prover.gen_chunk_proof("t", g1.task_id, g1.chunk_count, chain, "evm", g1.batch_data)
    g3 = prover.gen_aggregated_proof("t", g2.chunk_proofs[0].proof, g2.chunk_proofs[-1].proof)
    g4 = prover.gen_final_proof("t", g3.result_string, "BN128", RCFG["aggregator_addr"])
    for r in (w1, g1, g2, g3, g4):
        assert r.result_code == ProofResultCode.COMPLETED_OK, r.error_message
    return prover, w1, (g1, g2, g3, g4)


def test_recursion_steps_one_to_three_are_byte_identical(recursion_slices):
    """Step 1 against the JAX prover's; steps 2 and 3 against the sha256 of
    the JAX package's own strings (the golden file, which
    tests/test_torch_slice_golden.py holds the JAX package to)."""
    _, w1, (g1, g2, g3, _) = recursion_slices
    assert (g1.task_id, g1.chunk_count, g1.batch_data) == (w1.task_id, w1.chunk_count, w1.batch_data)
    assert [_sha(c.proof) for c in g2.chunk_proofs] == REC["sha256"]["chunk_proofs"]
    assert _sha(g3.result_string) == REC["sha256"]["aggregated"]
    agg = json.loads(g3.result_string)
    assert [k["type"] for k in agg["children"]] == ["chunk-attested"] * 2
    assert "stark" not in agg["children"][0]  # validity rests on the attestations alone


@pytest.mark.parametrize("part", ["chunk_proofs", "aggregated", "final_proof", "public_input"])
def test_recursion_slice_matches_the_golden_file(recursion_slices, part):
    _, _, (_, r2, r3, r4) = recursion_slices
    got = {
        "chunk_proofs": [_sha(c.proof) for c in r2.chunk_proofs],
        "aggregated": _sha(r3.result_string),
        "final_proof": _sha(r4.final_proof.proof),
        "public_input": _sha(r4.final_proof.public_input),
    }
    assert got[part] == REC["sha256"][part]


def test_recursion_final_step_checks_the_attestations(recursion_slices):
    """A corrupted attestation inside the aggregated proof, a tampered chunk
    before aggregation, and an aggregated digest that does not match all
    come back as COMPLETED_ERROR."""
    prover, _, (_, g2, g3, _) = recursion_slices
    bad = json.loads(g3.result_string)
    row = bad["children"][0]["air_proof"]["trace_openings"][0][0]["row"]
    row[0] = str((int(row[0]) + 1) % gl.P)
    res = prover.gen_final_proof("t", json.dumps(bad), "BN128", RCFG["aggregator_addr"])
    assert res.result_code == ProofResultCode.COMPLETED_ERROR
    bad = json.loads(g3.result_string)
    bad["digest"][0] = str((int(bad["digest"][0]) + 1) % gl.P)
    res = prover.gen_final_proof("t", json.dumps(bad), "BN128", RCFG["aggregator_addr"])
    assert res.result_code == ProofResultCode.COMPLETED_ERROR
    node = json.loads(g2.chunk_proofs[0].proof)
    node["stark"]["trace_openings"][0][0]["row"][1] = "1"
    agg = json.loads(g3.result_string)
    res = prover.gen_aggregated_proof("t", json.dumps(agg["children"][1]), json.dumps(node))
    assert res.result_code == ProofResultCode.COMPLETED_ERROR
    # an attested child is taken as it is (validated, not attested again)
    res = prover.gen_aggregated_proof("t", json.dumps(agg["children"][0]),
                                      json.dumps(agg["children"][1]))
    assert res.result_code == ProofResultCode.COMPLETED_OK
    assert res.result_string == g3.result_string


