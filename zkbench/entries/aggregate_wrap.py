"""Step 3 in the wrap profile over the ProverStream gRPC stream:
`RemoteBatchProver.gen_aggregated_proof` against a `ProverServiceServer`
that serves the configuration's `BatchProver`, both in this process over a
loopback channel (the configuration's `transport`).

A request's children are the two chunk proofs of its own payload (two full
chunks), made in set-up through step 2 over the same stream.  The timed call
is the node's side of step 3: the request serialised and sent, the two wrap
attestations proved on the server's handler thread, the response received
and parsed.  In a traced run the program's stage hook (`air.STAGE_HOOK`)
fires on the handler thread, synchronises the card at the end of each stage
of an attestation and records it as a span "attest.<stage>"; the first
attestation's trace stage runs from the request's start, the gRPC hop in.

A wrap attestation is too large to work out again in a run (the plain tree
over its 2^23 rows alone would take some 16 minutes), so the answers are the
aggregated proof's envelope and one verdict an attestation:
  * the envelope: the JSON with each wrap proof reduced to its statement
    (`air_wrap.STATEMENT`: the declared queries, grinding bits and blowup,
    the shape, the publics, the boundaries and the constants root), so it
    carries the chained digest and each child's type, q_c and header, and
    whether the string is the canonical dump of its own JSON;
  * a verdict: the plain verifier's result on the program's attestation
    under the configuration's pins, its instance replayed by the reference,
    "accepted" or the reason for rejection.  The verdicts are worked out in
    `answers`, after the window, never inside the timed call.
The reference works out the envelope from the request's inputs and expects
"accepted"; the check compares the envelope and one attestation's verdict,
drawn from the seed.
"""

from __future__ import annotations

import json
import threading
import weakref

import numpy as np
import torch

from .. import trace, work_fr
from ..reference import air_wrap, poseidon, service
from ..reference import recursion as ref_recursion
from ..reference import stark as ref_stark


class Driver:
    def __init__(self, prover, config: dict, traffic: dict, device):
        from eigen_zeth_tpu_torch.protocol.grpc_shim import ProverServiceServer, RemoteBatchProver

        self.prover, self.config, self.traffic = prover, config, traffic
        self.device = torch.device(device)
        self.spans = None  # a list while the run is traced
        t = config["transport"]
        self.server = ProverServiceServer(prover, host=t["host"], port=t["port"]).start()
        self.remote = RemoteBatchProver(f"{t['host']}:{self.server.port}")
        # A run that raises keeps the driver alive to the end; the server's
        # handler, blocked on the open stream, would then hold the exit.
        # Close before the interpreter waits on its threads.
        ref = weakref.ref(self)
        threading._register_atexit(lambda: ref() is not None and ref().close())
        self.pins = air_wrap.Pins.of(config)
        air = self.pins.air()
        self._work = work_fr.wrap_attestation(air.n, air.n_cols, air.ext_blowup) * 2

    def prepare(self, req):
        r = self.remote.gen_chunk_proof(req.batch_id, req.task_id, req.chunk_count,
                                        self.config["chain_id"], self.config["program_name"],
                                        req.batch_data)
        if r.result_code != 0 or len(r.chunk_proofs) != 2:
            raise RuntimeError(f"the children of request {req.index} failed: {r.error_message}")
        return req.batch_id, r.chunk_proofs[0].proof, r.chunk_proofs[1].proof

    def call(self, prepared):
        if self.spans is None:
            return self.remote.gen_aggregated_proof(*prepared)
        from eigen_zeth_tpu_torch.models import air

        last = [trace.now_ns()]

        def on_stage(name: str) -> None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            now = trace.now_ns()
            self.spans.append(trace.Span("attest." + name, last[0], now))
            last[0] = now

        air.STAGE_HOOK = on_stage
        try:
            return self.remote.gen_aggregated_proof(*prepared)
        finally:
            air.STAGE_HOOK = None

    def answers(self, out):
        if out.result_code != 0:
            return False, [], out.error_message
        return True, answers(out.result_string, self.pins, self.device), ""

    def units(self) -> int:
        return 2  # attestations a request

    def work(self):
        return self._work

    def close(self) -> None:
        if getattr(self, "server", None) is not None:
            self.remote.close()
            self.server.stop(0)
            self.server = None

    def __del__(self):
        self.close()


def envelope(agg: dict, canonical: bool) -> str:
    """The aggregated proof with each child's wrap proof reduced to its
    statement."""
    kids = []
    for child in agg["children"]:
        kid = dict(child)
        wp = kid.get("wrap_proof")
        if isinstance(wp, dict):
            kid["wrap_proof"] = {k: wp[k] for k in air_wrap.STATEMENT if k in wp}
        kids.append(kid)
    return json.dumps({"canonical": canonical, "aggregated": dict(agg, children=kids)})


def answers(result: str, pins, device) -> list:
    """[envelope, verdict of child 1, verdict of child 2] of an aggregated
    proof's JSON; a string that is no such JSON is one answer."""
    try:
        agg = json.loads(result)
        kids = agg["children"]
        env = envelope(agg, json.dumps(agg) == result)
    except (ValueError, KeyError, TypeError, AttributeError):
        return [result]
    return [env] + air_wrap.verify_many(kids, pins, device)


def pick(seed: int, index: int) -> list:
    """The answers of request `index` that the check compares: the envelope
    and one attestation's verdict, drawn from the seed."""
    return [0, 1 + int(np.random.default_rng([seed, index, 3]).integers(2))]


def expected(req, config: dict, device, which=None) -> list:
    """The reference's answers for the request's payload: the envelope
    worked out from its two chunk proofs (their headers and query counts,
    each attestation's statement at the pins, the chained digest), and
    "accepted" for each attestation."""
    p = config["prover"]
    pins = air_wrap.Pins.of(config)
    params = ref_stark.StarkParams(**p["stark_params"])
    kids = service.chunk_proofs(req.batch_data, req.task_id, req.chunk_count,
                                config["chain_id"], params, p["chunk_trace_rows"],
                                config["chunk_elems"], device=device)
    children, digests = [], []
    for k in kids:
        child = json.loads(k["proof"])["stark"]
        att = {"type": "chunk-attested-wrap", "q_c": len(child["fri"]["queries"]),
               "header": ref_recursion.child_header(child)}
        att["wrap_proof"] = air_wrap.statement(att, pins)
        digests.append(service.chunk_digest(att["header"]))
        children.append(att)
    digest = poseidon.hash_two_host(*digests)
    agg = {"type": "aggregated", "digest": [str(x) for x in digest], "children": children}
    out = [json.dumps({"canonical": True, "aggregated": agg}), "accepted", "accepted"]
    return out if which is None else [a if i in which else None for i, a in enumerate(out)]
