"""The port's gRPC ProverService against the JAX package's, on the wire.

The same ProverRequests go through the JAX package's `_handle_request` on
its `BatchProver` and through the port's on the port's (CPU tensors), at
the test profile (16-row chunks, blowup 4, 2 queries, terminal 16, the
linear wrap, recursion off; blocks of the SyntheticExecutor): the
serialized responses of the four steps, and of malformed requests, must be
byte-identical.  Over real gRPC both ways round (the JAX node-side client
and state machine against the port's server, the port's against the JAX
server) the ProofResult must equal the JAX pipeline's on the JAX prover
in-process.  Tolerance: none.
"""

import pytest
import torch

from eigen_zeth_tpu.models import stark as jstark
from eigen_zeth_tpu.protocol import grpc_shim as jshim
from eigen_zeth_tpu.protocol import kv as jkv
from eigen_zeth_tpu.protocol import prover_service as jps
from eigen_zeth_tpu.protocol import state_machine as jsm
from eigen_zeth_tpu.protocol.grpc_gen.prover.v1 import prover_pb2 as jpb
from eigen_zeth_tpu.utils.profiling import ProverTelemetry as JProverTelemetry
from eigen_zeth_tpu_torch.models import stark
from eigen_zeth_tpu_torch.protocol import grpc_shim as shim
from eigen_zeth_tpu_torch.protocol import kv, state_machine
from eigen_zeth_tpu_torch.protocol import prover_service as ps
from eigen_zeth_tpu_torch.protocol.grpc_gen.prover.v1 import prover_pb2 as pb
from eigen_zeth_tpu_torch.utils.profiling import ProverTelemetry

SP = dict(blowup=4, num_queries=2, terminal_size=16)
PROFILE = dict(wrap="linear", chunk_trace_rows=16, recursion=False)
BLOCKS = [17, 18, 19]  # 160 bytes of payload: 2 chunks of 15 elements
PIPELINE_BLOCK = 23


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the run spreads files over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_stark():
    """The JAX package's numpy chunk STARK (its CPU test path)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EZT_FORCE_NP_STARK", "1")
        yield


@pytest.fixture(scope="module")
def provers(np_stark):
    jprover = jps.BatchProver(stark_params=jstark.StarkParams(**SP), use_jit=False, **PROFILE)
    prover = ps.BatchProver(stark_params=stark.StarkParams(**SP), device=torch.device("cpu"),
                            **PROFILE)
    return jprover, prover


def _requests(jprover):
    """The four steps' requests, built as the reference client does, each
    from the JAX package's answer to the one before; with the JAX responses."""
    reqs, resps = [], []

    def step(fill):
        req = pb.ProverRequest(id=str(len(reqs) + 1))
        fill(req)
        reqs.append(req)
        resps.append(jshim._handle_request(jprover, req))
        return resps[-1]

    def chunks(r):
        m = r.gen_batch_proof.gen_batch_chunks
        m.batch_id, m.chain_id, m.program_name = "b-17", 12345, "evm"
        m.batch.block_number.extend(BLOCKS)

    c = step(chunks).gen_batch_proof.gen_batch_chunks

    def prove(r):
        m = r.gen_batch_proof.gen_chunk_proof
        m.batch_id, m.task_id, m.chunk_count = "b-17", c.task_id, c.chunk_count
        m.chain_id, m.program_name, m.batch_data = 12345, "evm", c.batch_data

    p = step(prove).gen_batch_proof.gen_chunk_proof.batch_proof_result.chunk_proofs

    def agg(r):
        m = r.gen_aggregated_proof
        m.batch_id, m.recursive_proof_1, m.recursive_proof_2 = "b-17", p[0].proof, p[-1].proof

    a = step(agg).gen_aggregated_proof

    def final(r):
        m = r.gen_final_proof
        m.batch_id, m.recursive_proof = "b-17", a.result_string
        m.curve_name, m.aggregator_addr = "BN128", "0x" + "33" * 20

    step(final)
    return reqs, resps


@pytest.fixture(scope="module")
def steps(provers):
    """(requests, JAX responses): computed once for the module."""
    reqs, resps = _requests(provers[0])
    assert [r.WhichOneof("response_type") for r in resps] == [
        "gen_batch_proof", "gen_batch_proof", "gen_aggregated_proof", "gen_final_proof"]
    assert resps[0].gen_batch_proof.gen_batch_chunks.chunk_count == 2
    return reqs, resps


def test_descriptors_are_the_jax_ones():
    assert pb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert shim.VERSION_PROTO == jshim.VERSION_PROTO == "v1"
    assert shim.VERSION_SERVER.startswith("eigen-zeth-tpu")
    assert (shim.SERVICE_NAME, shim.METHOD_NAME) == (jshim.SERVICE_NAME, jshim.METHOD_NAME)


@pytest.mark.parametrize("i", range(4), ids=["chunks", "chunk-proof", "aggregate", "final"])
def test_responses_are_byte_identical(provers, steps, i):
    reqs, want = steps
    got = shim._handle_request(provers[1], reqs[i])
    assert got.SerializeToString() == want[i].SerializeToString()
    result = getattr(got, got.WhichOneof("response_type"))
    if i < 2:
        result = getattr(result, result.WhichOneof("step"))
    assert result.result_code == pb.ProofResultCode.COMPLETED_OK
    assert isinstance(got.gen_batch_proof.gen_batch_chunks.pre_state_root, bytes)


def _status_fields(resp):
    """The GetStatus response with the fields of the host and the moment
    cleared: prover id, times, cores, memory and the server's version."""
    out = pb.ProverResponse()
    out.CopyFrom(resp)
    st = out.get_status.prover_status
    for name in ("prover_id", "last_computed_end_time", "current_computing_start_time",
                 "number_of_cores", "total_memory", "free_memory", "version_server"):
        st.ClearField(name)
    return out.SerializeToString()


@pytest.mark.parametrize("busy", [False, True], ids=["idle", "computing"])
def test_get_status_matches_field_by_field(provers, busy, monkeypatch):
    monkeypatch.setenv("FORK_ID", "7")
    for mod in (shim, jshim):
        mod.global_env.cache_clear()
    tels = [JProverTelemetry(), ProverTelemetry()]
    for tel in tels:
        tel.enqueue("4")
        tel.enqueue("5")
        tel.start("3")
        tel.finish("3")
        if busy:
            tel.start("4")
    req = pb.ProverRequest(id="9")
    req.get_status.SetInParent()
    try:
        want = jshim._handle_request(provers[0], req, tels[0])
        got = shim._handle_request(provers[1], req, tels[1])
    finally:
        for mod in (shim, jshim):
            mod.global_env.cache_clear()
    assert _status_fields(got) == _status_fields(want)
    st = got.get_status.prover_status
    assert (st.fork_id, st.last_computed_request_id, list(st.pending_request_queue_ids)) == (
        7, "3", ["5"] if busy else ["4", "5"])
    assert got.get_status.status == (pb.GetStatusResponse.Status.STATUS_COMPUTING if busy
                                     else pb.GetStatusResponse.Status.STATUS_IDLE)
    assert st.total_memory > 0 and st.number_of_cores >= 1


MALFORMED = {
    "no-blocks": lambda r: r.gen_batch_proof.gen_batch_chunks.SetInParent(),
    "chunk-proof-bad-base64": lambda r: setattr(
        r.gen_batch_proof.gen_chunk_proof, "batch_data", "!!notb64"),
    "aggregate-not-json": lambda r: setattr(
        r.gen_aggregated_proof, "recursive_proof_1", "not json"),
    "final-not-json": lambda r: setattr(r.gen_final_proof, "recursive_proof", "not json"),
    "final-bad-curve": lambda r: setattr(r.gen_final_proof, "curve_name", "BLS12-381"),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_requests_give_the_jax_completed_error(provers, case):
    req = pb.ProverRequest(id="1")
    MALFORMED[case](req)
    want = jshim._handle_request(provers[0], req)
    got = shim._handle_request(provers[1], req)
    assert got.SerializeToString() == want.SerializeToString()
    result = getattr(got, got.WhichOneof("response_type"))
    if result.DESCRIPTOR.name == "GenBatchProofResponse":
        result = getattr(result, result.WhichOneof("step"))
    assert result.result_code == pb.ProofResultCode.COMPLETED_ERROR and result.error_message


@pytest.mark.parametrize("mod", [jshim, shim], ids=["jax", "port"])
def test_a_request_without_a_type_raises_on_both(provers, mod):
    with pytest.raises(ValueError, match="unknown request type"):
        mod._handle_request(provers[0] if mod is jshim else provers[1], pb.ProverRequest(id="1"))


def _result(r):
    return (r.block_number, r.proof, r.public_input, r.pre_state_root, r.post_state_root)


@pytest.fixture(scope="module")
def jax_in_process(provers):
    """The JAX pipeline on the JAX prover, in process: the reference result."""
    return _result(jsm.ProverPipeline(jkv.MemDb(), provers[0]).execute(PIPELINE_BLOCK))


def test_jax_node_against_the_port_server(provers, jax_in_process):
    server = shim.ProverServiceServer(provers[1]).start()
    remote = jshim.RemoteBatchProver(f"http://127.0.0.1:{server.port}")
    try:
        got = jsm.ProverPipeline(jkv.MemDb(), remote).execute(PIPELINE_BLOCK)
        status = remote.get_status()
    finally:
        remote.close()
        server.stop()
    assert _result(got) == jax_in_process
    assert status.status == pb.GetStatusResponse.Status.STATUS_IDLE
    assert status.prover_status.last_computed_request_id == "4"
    assert status.prover_status.version_server == shim.VERSION_SERVER


def test_port_node_against_the_jax_server(provers, jax_in_process):
    server = jshim.ProverServiceServer(provers[0]).start()
    remote = shim.RemoteBatchProver(f"127.0.0.1:{server.port}")
    try:
        got = state_machine.ProverPipeline(kv.MemDb(), remote).execute(PIPELINE_BLOCK)
    finally:
        remote.close()
        server.stop()
    assert _result(got) == jax_in_process
