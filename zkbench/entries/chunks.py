"""Step 2, `BatchProver.gen_chunk_proof`, on the chunks of one payload.

The answers are the request's chunk proofs, one string each of its chunk
id, proof key and proof JSON (the trace, LDE, Merkle roots and paths,
composition, FRI layers and openings)."""

from __future__ import annotations

import json

from .. import traffic as traffic_m
from .. import work
from ..reference import service
from ..reference import stark as ref_stark


class Driver:
    def __init__(self, prover, config: dict, traffic: dict, device):
        self.prover, self.config, self.traffic, self.device = prover, config, traffic, device
        self.spans = None
        p = config["prover"]
        sp = p["stark_params"]
        self._chunks = traffic_m.chunk_count(traffic, config)
        self._work = work.chunk_batch(self._chunks, p["chunk_trace_rows"], sp["blowup"],
                                      sp["terminal_size"])

    def prepare(self, req):
        return req

    def call(self, req):
        return self.prover.gen_chunk_proof(req.batch_id, req.task_id, req.chunk_count,
                                           self.config["chain_id"],
                                           self.config["program_name"], req.batch_data)

    def answers(self, out):
        if out.result_code != 0:
            return False, [], out.error_message
        return True, [json.dumps([c.chunk_id, c.proof_key, c.proof]) for c in out.chunk_proofs], ""

    def units(self) -> int:
        return self._chunks

    def work(self) -> work.Work:
        return self._work


def expected(req, config: dict, device, which=None) -> list:
    """The reference's chunk proofs for the request's payload, all of them."""
    p = config["prover"]
    params = ref_stark.StarkParams(**p["stark_params"])
    kids = service.chunk_proofs(req.batch_data, req.task_id, req.chunk_count,
                                config["chain_id"], params, p["chunk_trace_rows"],
                                config["chunk_elems"], device=device)
    return [json.dumps([k["chunk_id"], k["proof_key"], k["proof"]]) for k in kids]
