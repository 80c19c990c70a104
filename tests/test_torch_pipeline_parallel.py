"""The port's pipelined prover against the JAX package's.

`PipelinedBatchProver` proves a batch's chunks on a producer thread while
host threads aggregate finished pairs.  At the test profile (blowup 4,
2 queries, terminal 16, the linear wrap, recursion off; SyntheticExecutor
blocks whose payload makes 2 and 3 chunks of the prover's 15 elements)
the port's recursive string must equal the JAX package's byte for byte,
and it must feed the final wrap.  Tolerance: none.
"""

import json

import pytest
import torch

from eigen_zeth_tpu.models import stark as jstark
from eigen_zeth_tpu.parallel.pipeline import PipelinedBatchProver as JPipelinedBatchProver
from eigen_zeth_tpu.protocol import prover_service as jps
from eigen_zeth_tpu_torch.models import stark
from eigen_zeth_tpu_torch.parallel.pipeline import PipelinedBatchProver
from eigen_zeth_tpu_torch.protocol import prover_service as ps
from eigen_zeth_tpu_torch.protocol.messages import ProofResultCode

SP = dict(blowup=4, num_queries=2, terminal_size=16)
PROFILE = dict(wrap="linear", chunk_trace_rows=16, recursion=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the run spreads files over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_chunks, blocks", [(2, [21, 22]), (3, [21, 22, 23, 24, 25])],
                         ids=["2-chunks", "3-chunks"])
def test_pipelined_recursive_string_equals_jax(n_chunks, blocks, monkeypatch):
    monkeypatch.setenv("EZT_FORCE_NP_STARK", "1")
    jprover = jps.BatchProver(stark_params=jstark.StarkParams(**SP), use_jit=False, **PROFILE)
    prover = ps.BatchProver(stark_params=stark.StarkParams(**SP), device=torch.device("cpu"),
                            **PROFILE)
    chunks = prover.gen_batch_chunks("b", blocks, 12345, "evm")
    assert chunks.chunk_count == n_chunks
    args = ("b", chunks.task_id, chunks.chunk_count, 12345, "evm", chunks.batch_data)
    want = JPipelinedBatchProver(jprover, agg_workers=2).prove_and_aggregate(*args)
    got = PipelinedBatchProver(prover, agg_workers=2).prove_and_aggregate(*args)
    assert got == want
    assert json.loads(got)["type"] == "aggregated"
    final = prover.gen_final_proof("b", got, "BN128", "0xagg")
    assert final.result_code == ProofResultCode.COMPLETED_OK


def test_a_failing_chunk_proof_raises_instead_of_waiting(monkeypatch):
    """The producer's exception reaches the caller (the JAX package's
    consumer would wait for the chunk forever)."""
    prover = ps.BatchProver(stark_params=stark.StarkParams(**SP), device=torch.device("cpu"),
                            **PROFILE)

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(stark, "prove_chunk", broken)
    chunks = prover.gen_batch_chunks("b", [21, 22], 12345, "evm")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        PipelinedBatchProver(prover).prove_and_aggregate(
            "b", chunks.task_id, chunks.chunk_count, 12345, "evm", chunks.batch_data)
