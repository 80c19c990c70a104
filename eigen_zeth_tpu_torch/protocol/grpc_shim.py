"""gRPC ProverService — port of eigen_zeth_tpu/protocol/grpc_shim.py,
wire-compatible with eigen-zeth.

The reference node reaches its prover network over one bidirectional
gRPC stream (service ProverService { rpc ProverStream (stream
ProverRequest) returns (stream ProverResponse) },
proto/prover/v1/prover.proto:9-11; client at src/prover/provider.rs:
564-706).  `ProverServiceServer` serves that wire surface on the port's
`BatchProver`, so an unmodified node (the JAX package's `run
--prover-addr`, or eigen-zeth with PROVER_ADDR) gets its proofs from the
card.  The message classes are the protoc output copied from the JAX
package (grpc_gen/); the service is registered through grpc's generic
handlers.

`ProverStreamClient` is the reference ProverEndpoint's send/receive
discipline (request ids, one request in flight), and `RemoteBatchProver`
the node-side `BatchProver` interface over it, which the state machine
drives as it drives an in-process prover.

Requests run on the server's pool threads, one at a time per stream; the
prover names its device explicitly, so no thread's current CUDA device
matters.  Import this module before anything else imports grpc: it turns
gRPC's fork handlers off (see below).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent import futures
from typing import Iterator, Optional

# The prover forks host workers from this process (models/groth16.py,
# `_over_ranges`), on a handler thread while gRPC's threads run; the
# workers never call gRPC.  gRPC's fork handlers, which its core installs
# unless this is off when grpc is first imported, restart gRPC's threads in
# each child, where they abort (an H100 host, grpcio 1.80): a worker that
# dies after taking its range leaves the pass waiting forever.
os.environ.setdefault("GRPC_ENABLE_FORK_SUPPORT", "0")

import grpc  # noqa: E402

from ..utils.config import global_env
from ..utils.profiling import ProverTelemetry
from .grpc_gen.prover.v1 import prover_pb2 as pb
from .messages import ProofResultCode
from .prover_service import BatchProver

SERVICE_NAME = "prover.v1.ProverService"
METHOD_NAME = "ProverStream"

VERSION_PROTO = "v1"
VERSION_SERVER = "eigen-zeth-tpu-torch-0.1.0"


def _handle_request(
    prover: BatchProver,
    req: pb.ProverRequest,
    telemetry: Optional[ProverTelemetry] = None,
) -> pb.ProverResponse:
    resp = pb.ProverResponse(id=req.id)
    which = req.WhichOneof("request_type")

    if which == "get_status":
        # full ProverStatus health block (prover.proto:161-190)
        tel = telemetry or ProverTelemetry()
        out = resp.get_status
        out.id = req.id
        out.result_code = pb.GetStatusResultCode.OK
        out.status = (
            pb.GetStatusResponse.Status.STATUS_COMPUTING
            if tel.computing
            else pb.GetStatusResponse.Status.STATUS_IDLE
        )
        snap = tel.snapshot()
        ps = out.prover_status
        ps.last_computed_request_id = snap["last_computed_request_id"]
        ps.last_computed_end_time = snap["last_computed_end_time"]
        ps.current_computing_request_id = snap["current_computing_request_id"]
        ps.current_computing_start_time = snap["current_computing_start_time"]
        ps.version_proto = VERSION_PROTO
        ps.version_server = VERSION_SERVER
        ps.pending_request_queue_ids.extend(snap["pending_request_queue_ids"])
        ps.prover_name = snap["prover_name"]
        ps.prover_id = snap["prover_id"]
        ps.number_of_cores = snap["number_of_cores"]
        ps.total_memory = snap["total_memory"]
        ps.free_memory = snap["free_memory"]
        ps.fork_id = global_env().fork_id
        return resp

    if which == "gen_batch_proof":
        step = req.gen_batch_proof.WhichOneof("step")
        if step == "gen_batch_chunks":
            m = req.gen_batch_proof.gen_batch_chunks
            r = prover.gen_batch_chunks(
                m.batch_id, list(m.batch.block_number), m.chain_id, m.program_name
            )
            out = resp.gen_batch_proof.gen_batch_chunks
            out.batch_id = r.batch_id
            out.task_id = r.task_id
            out.result_code = int(r.result_code)
            out.chunk_count = r.chunk_count
            out.batch_data = r.batch_data
            out.pre_state_root = r.pre_state_root
            out.post_state_root = r.post_state_root
            out.error_message = r.error_message
            return resp
        if step == "gen_chunk_proof":
            m = req.gen_batch_proof.gen_chunk_proof
            r = prover.gen_chunk_proof(
                m.batch_id, m.task_id, m.chunk_count, m.chain_id,
                m.program_name, m.batch_data,
            )
            out = resp.gen_batch_proof.gen_chunk_proof
            out.batch_id = r.batch_id
            out.task_id = r.task_id
            out.result_code = int(r.result_code)
            out.error_message = r.error_message
            out.batch_proof_result.task_id = r.task_id
            for cp in r.chunk_proofs:
                entry = out.batch_proof_result.chunk_proofs.add()
                entry.chunk_id = cp.chunk_id
                entry.proof_key = cp.proof_key
                entry.proof = cp.proof
            return resp
        raise ValueError(f"unknown gen_batch_proof step {step!r}")

    if which == "gen_aggregated_proof":
        m = req.gen_aggregated_proof
        r = prover.gen_aggregated_proof(
            m.batch_id, m.recursive_proof_1, m.recursive_proof_2
        )
        out = resp.gen_aggregated_proof
        out.batch_id = r.batch_id
        out.result_code = int(r.result_code)
        out.result_string = r.result_string
        out.error_message = r.error_message
        return resp

    if which == "gen_final_proof":
        m = req.gen_final_proof
        r = prover.gen_final_proof(
            m.batch_id, m.recursive_proof, m.curve_name, m.aggregator_addr
        )
        out = resp.gen_final_proof
        out.batch_id = r.batch_id
        out.result_code = int(r.result_code)
        out.result_string = r.result_string
        out.error_message = r.error_message
        if r.final_proof is not None:
            out.final_proof.proof = r.final_proof.proof
            out.final_proof.public_input = r.final_proof.public_input
        return resp

    raise ValueError(f"unknown request type {which!r}")


class ProverServiceServer:
    """Serves prover.v1.ProverService/ProverStream over real gRPC."""

    def __init__(self, prover: BatchProver, host: str = "127.0.0.1", port: int = 0):
        self.prover = prover
        self.telemetry = ProverTelemetry()

        def stream_handler(request_iterator, context) -> Iterator[pb.ProverResponse]:
            for req in request_iterator:
                compute = req.WhichOneof("request_type") != "get_status"
                if compute:
                    self.telemetry.enqueue(req.id)
                    self.telemetry.start(req.id)
                try:
                    yield _handle_request(self.prover, req, self.telemetry)
                finally:
                    if compute:
                        self.telemetry.finish(req.id)

        handler = grpc.method_handlers_generic_handler(
            SERVICE_NAME,
            {
                METHOD_NAME: grpc.stream_stream_rpc_method_handler(
                    stream_handler,
                    request_deserializer=pb.ProverRequest.FromString,
                    response_serializer=pb.ProverResponse.SerializeToString,
                )
            },
        )
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self.server.add_generic_rpc_handlers((handler,))
        self.port = self.server.add_insecure_port(f"{host}:{port}")

    def start(self) -> "ProverServiceServer":
        self.server.start()
        return self

    def stop(self, grace: float = 2.0):
        self.server.stop(grace)


class ProverStreamClient:
    """The reference ProverEndpoint's send/receive discipline
    (src/prover/provider.rs:631-703): one bidi stream, requests pushed
    with ids, responses matched back.  On stream failure the client
    reconnects with the reference's 5s backoff (provider.rs:605-621) and
    the caller retries the in-flight step (provider.rs:345-348)."""

    RECONNECT_BACKOFF_S = 5.0  # provider.rs:618

    def __init__(self, addr: str, max_retries: int = 3):
        self.addr = addr
        self.max_retries = max_retries
        self._id = 0
        self._lock = threading.Lock()
        self._connect()

    def _connect(self):
        self.channel = grpc.insecure_channel(self.addr)
        self._call = self.channel.stream_stream(
            f"/{SERVICE_NAME}/{METHOD_NAME}",
            request_serializer=pb.ProverRequest.SerializeToString,
            response_deserializer=pb.ProverResponse.FromString,
        )
        self._q: queue.Queue = queue.Queue()
        self._responses = self._call(iter(self._q.get, None))

    def request(self, build) -> pb.ProverResponse:
        """build(req) fills one request; blocks for its response.
        Retries the same request over a fresh stream on transport error."""
        with self._lock:
            self._id += 1
            req = pb.ProverRequest(id=str(self._id))
            build(req)
            last_err = None
            for attempt in range(self.max_retries + 1):
                try:
                    self._q.put(req)
                    resp = next(self._responses)
                    assert resp.id == req.id, (resp.id, req.id)
                    return resp
                except (grpc.RpcError, StopIteration) as e:
                    last_err = e
                    if attempt == self.max_retries:
                        break
                    time.sleep(self.RECONNECT_BACKOFF_S * (attempt > 0))
                    try:
                        self.channel.close()
                    except Exception:
                        pass
                    self._connect()
            raise ConnectionError(
                f"prover stream failed after {self.max_retries} retries"
            ) from last_err

    def close(self):
        self._q.put(None)
        self.channel.close()


class RemoteBatchProver:
    """Node-side adapter: the BatchProver interface spoken over the gRPC
    stream to a prover process at PROVER_ADDR — the reference's actual
    topology (src/prover/provider.rs connects the node to an external
    prover network; scripts/launch-pos-eigen-zeth-node.sh:52-61).  Drop-in
    for ProverPipeline, so the node runs identically whether the prover
    is in-process or remote."""

    def __init__(self, addr: str, max_retries: int = 3):
        if addr.startswith("http://"):
            addr = addr[len("http://"):]
        self.client = ProverStreamClient(addr, max_retries=max_retries)

    def get_status(self) -> pb.GetStatusResponse:
        def build(req):
            req.get_status.SetInParent()

        return self.client.request(build).get_status

    def gen_batch_chunks(self, batch_id, block_numbers, chain_id, program_name):
        from .messages import GenBatchChunksResult

        def build(req):
            m = req.gen_batch_proof.gen_batch_chunks
            m.batch_id = batch_id
            m.batch.block_number.extend(block_numbers)
            m.chain_id = chain_id
            m.program_name = program_name

        r = self.client.request(build).gen_batch_proof.gen_batch_chunks
        return GenBatchChunksResult(
            batch_id=r.batch_id,
            task_id=r.task_id,
            result_code=ProofResultCode(r.result_code),
            chunk_count=r.chunk_count,
            batch_data=r.batch_data,
            pre_state_root=r.pre_state_root,
            post_state_root=r.post_state_root,
            error_message=r.error_message,
        )

    def gen_chunk_proof(self, batch_id, task_id, chunk_count, chain_id,
                        program_name, batch_data):
        from .messages import ChunkProof, GenChunkProofResult

        def build(req):
            m = req.gen_batch_proof.gen_chunk_proof
            m.batch_id = batch_id
            m.task_id = task_id
            m.chunk_count = chunk_count
            m.chain_id = chain_id
            m.program_name = program_name
            m.batch_data = batch_data

        r = self.client.request(build).gen_batch_proof.gen_chunk_proof
        return GenChunkProofResult(
            batch_id=r.batch_id,
            task_id=r.task_id,
            result_code=ProofResultCode(r.result_code),
            chunk_proofs=[
                ChunkProof(chunk_id=cp.chunk_id, proof_key=cp.proof_key, proof=cp.proof)
                for cp in r.batch_proof_result.chunk_proofs
            ],
            error_message=r.error_message,
        )

    def gen_aggregated_proof(self, batch_id, recursive_proof_1, recursive_proof_2):
        from .messages import GenAggregatedProofResult

        def build(req):
            m = req.gen_aggregated_proof
            m.batch_id = batch_id
            m.recursive_proof_1 = recursive_proof_1
            m.recursive_proof_2 = recursive_proof_2

        r = self.client.request(build).gen_aggregated_proof
        return GenAggregatedProofResult(
            batch_id=r.batch_id,
            result_code=ProofResultCode(r.result_code),
            result_string=r.result_string,
            error_message=r.error_message,
        )

    def gen_final_proof(self, batch_id, recursive_proof, curve_name, aggregator_addr):
        from .messages import FinalProof, GenFinalProofResult

        def build(req):
            m = req.gen_final_proof
            m.batch_id = batch_id
            m.recursive_proof = recursive_proof
            m.curve_name = curve_name
            m.aggregator_addr = aggregator_addr

        r = self.client.request(build).gen_final_proof
        final = None
        if r.HasField("final_proof"):
            final = FinalProof(
                proof=r.final_proof.proof, public_input=r.final_proof.public_input
            )
        return GenFinalProofResult(
            batch_id=r.batch_id,
            result_code=ProofResultCode(r.result_code),
            result_string=r.result_string,
            final_proof=final,
            error_message=r.error_message,
        )

    def close(self):
        self.client.close()
