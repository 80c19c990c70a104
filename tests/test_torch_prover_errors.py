"""Malformed input to the port's four steps gives the reference's result.

The JAX package's `BatchProver` puts each step under `except Exception` and
returns COMPLETED_ERROR with the error's text.  A node's pipeline retries
only on a non-OK result code, so a step that raised instead would end the
batch.  Each case runs the same call on a JAX prover and on the port's
(CPU tensors) and holds the port's result code to the JAX one, which is
COMPLETED_ERROR in every case here.  No proof is made: every input fails
before any proving starts.
"""

import json

import pytest
import torch

from eigen_zeth_tpu.models import stark as jstark
from eigen_zeth_tpu.protocol import prover_service as jps
from eigen_zeth_tpu_torch.models import stark
from eigen_zeth_tpu_torch.protocol import prover_service as ps
from eigen_zeth_tpu_torch.protocol.messages import ProofResultCode

CPU = torch.device("cpu")
SP = dict(blowup=4, num_queries=2, terminal_size=32)
ADDR = "0x" + "11" * 20


def _provers(wrap="linear", recursion=False, executor=None):
    kw = dict(wrap=wrap, recursion=recursion, chunk_trace_rows=8)
    jprover = jps.BatchProver(stark_params=jstark.StarkParams(**SP), use_jit=False,
                              executor=executor, **kw)
    prover = ps.BatchProver(stark_params=stark.StarkParams(**SP), device=CPU,
                            executor=executor, **kw)
    return jprover, prover


class _FailingExecutor:
    def execute(self, block_numbers, chain_id):
        raise RuntimeError("execution client unreachable")


CASES = {
    "chunk-proof-bad-base64": lambda p: p.gen_chunk_proof("b", "1", 1, 7, "evm", "!!notb64"),
    "aggregate-not-json": lambda p: p.gen_aggregated_proof("b", "not json", "not json"),
    "aggregate-no-children": lambda p: p.gen_aggregated_proof(
        "b", json.dumps({"type": "aggregated"}), json.dumps({"type": "aggregated"})),
    "final-not-json": lambda p: p.gen_final_proof("b", "not json", "BN128", ADDR),
    "final-chunk-without-proof": lambda p: p.gen_final_proof(
        "b", json.dumps({"type": "chunk"}), "BN128", ADDR),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_malformed_input_is_completed_error(case):
    jprover, prover = _provers()
    want = CASES[case](jprover)
    got = CASES[case](prover)
    assert want.result_code == ProofResultCode.COMPLETED_ERROR
    assert got.result_code == want.result_code
    assert got.error_message


def test_executor_failure_is_completed_error():
    jprover, prover = _provers(executor=_FailingExecutor())
    want = jprover.gen_batch_chunks("b", [1, 2], 7, "evm")
    got = prover.gen_batch_chunks("b", [1, 2], 7, "evm")
    assert want.result_code == got.result_code == ProofResultCode.COMPLETED_ERROR
    assert got.error_message == want.error_message == "execution client unreachable"
    assert (got.chunk_count, got.batch_data) == (want.chunk_count, want.batch_data)


@pytest.mark.parametrize("node", [
    {"type": "aggregated", "digest": ["0"] * 4,
     "children": [{"type": "chunk-attested-wrap", "q_c": 2, "header": {}}] * 2},
    {"type": "aggregated", "digest": ["0"] * 4, "children": [{"type": "chunk"}] * 2},
    {"type": "chunk-attested-wrap"},
], ids=["wrap-leaf-without-proof", "chunk-leaves", "not-aggregated"])
def test_stark_wrap_refuses_malformed_aggregates(node):
    """The STARK wrap's step 4 on malformed aggregated proofs: a wrap leaf
    with no header or proof, leaves that are no wrap attestations, a root
    that is no aggregate."""
    jprover, prover = _provers(wrap="stark", recursion=True)
    want = jprover.gen_final_proof("b", json.dumps(node), "BN128", ADDR)
    got = prover.gen_final_proof("b", json.dumps(node), "BN128", ADDR)
    assert want.result_code == ProofResultCode.COMPLETED_ERROR
    assert got.result_code == want.result_code
