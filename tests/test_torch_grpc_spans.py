"""The gRPC hop's spans, and step 3 over the ProverStream.

`ProverStreamClient.request` records "grpc.call" and the server's stream
handler "grpc.handle" around `_handle_request` (utils/profiling.py): each
with the request's kind, its batch id as the request id and the wire bytes
of the request and the response, the call also its retries.  The handle
runs on a server pool thread, so it is a root there, and the step's span
nests in it; it records while a torch.profiler session runs as while the
tracer is enabled, and nothing records while neither does.  The served
step 3 in the wrap profile is byte-identical to the same prover's
in-process step 3 on the same children (the small shape of
tests/zkbench_wrap_small.py, the attestations its store holds).
"""

import pytest
import torch
import zkbench_wrap_small as small

from eigen_zeth_tpu_torch.models import stark
from eigen_zeth_tpu_torch.protocol import grpc_shim as shim
from eigen_zeth_tpu_torch.protocol import prover_service as ps
from eigen_zeth_tpu_torch.utils import profiling
from zkbench import harness
from zkbench import traffic as traffic_m

CPU = torch.device("cpu")
DATA = "AAECAwQFBgcICQoLDA0ODxAREhMUFRYXGBkaGxwdHh8gISIjJCUmJygpKissLS4v"  # 48 bytes


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    profiling.disable()


def _serve(prover):
    server = shim.ProverServiceServer(prover).start()
    return server, shim.RemoteBatchProver(f"127.0.0.1:{server.port}")


@pytest.fixture
def served():
    prover = ps.BatchProver(stark_params=stark.StarkParams(blowup=4, num_queries=2,
                                                           terminal_size=16),
                            wrap="linear", chunk_trace_rows=16, recursion=False, device=CPU)
    server, remote = _serve(prover)
    yield remote
    remote.close()
    server.stop(0)


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_call_and_handle_are_recorded(served):
    profiling.enable()
    r = served.gen_chunk_proof("b-41", "7", 2, 12345, "evm", DATA)
    spans = profiling.disable()
    assert r.result_code == 0
    (call,), (handle,), (step,) = (_by_name(spans, n) for n in ("grpc.call", "grpc.handle",
                                                                 "step2"))
    for sp in (call, handle):
        assert sp.request == "b-41" and sp.attrs["kind"] == "gen_chunk_proof"
        assert sp.attrs["request_bytes"] > len(DATA)
        assert sp.attrs["response_bytes"] > sum(len(c.proof) for c in r.chunk_proofs)
    assert call.attrs["retries"] == 0
    assert step.parent is handle and handle.parent is None
    assert call.start_ns <= handle.start_ns <= handle.end_ns <= call.end_ns


def test_handle_nests_under_a_running_profiler(served):
    """No enable(): a torch.profiler session alone makes every thread
    record, the handler's too."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        served.gen_chunk_proof("b-42", "8", 2, 12345, "evm", DATA)
        spans = profiling.disable()
    (handle,) = _by_name(spans, "grpc.handle")
    (step,) = _by_name(spans, "step2")
    assert step.parent is handle and handle.request == "b-42"
    assert _by_name(spans, "grpc.call")[0].parent is None


def test_nothing_records_when_off(served):
    profiling.disable()
    served.gen_chunk_proof("b-43", "9", 2, 12345, "evm", DATA)
    assert profiling.disable() == []


def test_served_step3_equals_in_process(monkeypatch):
    small.use_store(monkeypatch)
    cell = small.small_cell()
    config = cell["config"]
    prover = harness.make_prover(config, CPU)
    server, remote = _serve(prover)
    try:
        req = traffic_m.request(small.SEED, 0, cell["traffic"], config)
        args = (req.batch_id, req.task_id, req.chunk_count, config["chain_id"],
                config["program_name"], req.batch_data)
        kids, kids_remote = prover.gen_chunk_proof(*args), remote.gen_chunk_proof(*args)
        assert [c.proof for c in kids_remote.chunk_proofs] == [c.proof for c in kids.chunk_proofs]
        pair = (req.batch_id, kids.chunk_proofs[0].proof, kids.chunk_proofs[1].proof)
        here, there = prover.gen_aggregated_proof(*pair), remote.gen_aggregated_proof(*pair)
        assert here.result_code == there.result_code == 0
        assert there.result_string == here.result_string
        assert '"chunk-attested-wrap"' in there.result_string
    finally:
        remote.close()
        server.stop(0)
