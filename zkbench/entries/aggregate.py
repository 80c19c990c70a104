"""Step 3, `BatchProver.gen_aggregated_proof`, on two chunk children.

A request's children are the two chunk proofs of its own payload (two full
chunks), made in set-up through the program's step 2.  The aggregated
proof's JSON (`result_string`) is checked as three answers: its envelope
(the JSON without the two AIR proofs: the type, the chained digest, each
child's type, query count and header, and whether the string is the
canonical dump of its own JSON, which makes the pieces the whole string)
and each attestation's AIR proof (every layer of it: the verifier trace's
commitment, LDE, Merkle paths, composition, FRI and openings).  The check
works out the envelope and one attestation, drawn from the seed: the
reference's attestation takes about as long as a run's window.  In a traced run the program's
stage hook (`air.STAGE_HOOK`) synchronises the card at the end of each
stage of an attestation and records it as a span "attest.<stage>"; the
trace stage runs from the attestation's start (the request's, or the end
of the previous attestation) to its hook.
"""

from __future__ import annotations

import json

import numpy as np

from .. import trace, work
from ..reference import recursion, service
from ..reference import stark as ref_stark


class Driver:
    def __init__(self, prover, config: dict, traffic: dict, device):
        self.prover, self.config, self.traffic, self.device = prover, config, traffic, device
        self.spans = None  # a list while the run is traced
        p = config["prover"]
        sp = p["stark_params"]
        rows = p["chunk_trace_rows"]
        terminal = min(rows * sp["blowup"], sp["terminal_size"])
        air, _, _, _ = recursion.attestation_air(rows, sp["num_queries"], terminal)
        self._work = work.attestation(air.n, air.n_cols, air.ext_blowup) * 2

    def prepare(self, req):
        r = self.prover.gen_chunk_proof(req.batch_id, req.task_id, req.chunk_count,
                                        self.config["chain_id"], self.config["program_name"],
                                        req.batch_data)
        if r.result_code != 0 or len(r.chunk_proofs) != 2:
            raise RuntimeError(f"the children of request {req.index} failed: {r.error_message}")
        return req.batch_id, r.chunk_proofs[0].proof, r.chunk_proofs[1].proof

    def call(self, prepared):
        if self.spans is None:
            return self.prover.gen_aggregated_proof(*prepared)
        import torch
        from eigen_zeth_tpu_torch.models import air

        last = [trace.now_ns()]

        def on_stage(name: str) -> None:
            torch.cuda.synchronize(self.device)
            now = trace.now_ns()
            self.spans.append(trace.Span("attest." + name, last[0], now))
            last[0] = now

        air.STAGE_HOOK = on_stage
        try:
            return self.prover.gen_aggregated_proof(*prepared)
        finally:
            air.STAGE_HOOK = None

    def answers(self, out):
        if out.result_code != 0:
            return False, [], out.error_message
        return True, split(out.result_string), ""

    def units(self) -> int:
        return 2  # attestations a request

    def work(self) -> work.Work:
        return self._work


def split(result: str) -> list:
    """[envelope, AIR proof of child 1, AIR proof of child 2] of an
    aggregated proof's JSON; a string that is no such JSON is one answer."""
    try:
        agg = json.loads(result)
        return pieces(agg, json.dumps(agg) == result)
    except (ValueError, KeyError, TypeError, AttributeError):
        return [result]


def pieces(agg: dict, canonical: bool) -> list:
    """The envelope, then each child's AIR proof (None where absent)."""
    proofs = [child.pop("air_proof") for child in agg["children"]]
    return [json.dumps({"canonical": canonical, "aggregated": agg})] + [
        None if p is None else json.dumps(p) for p in proofs]


def pick(seed: int, index: int) -> list:
    """The answers of request `index` that the check works out: the
    envelope and one attestation, drawn from the seed."""
    return [0, 1 + int(np.random.default_rng([seed, index, 3]).integers(2))]


def expected(req, config: dict, device, which=None) -> list:
    """The reference's answers for the request's payload (None where not
    worked out): its two chunk proofs, the attestations in `which` (all by
    default), and the envelope with the chained digest."""
    p = config["prover"]
    params = ref_stark.StarkParams(**p["stark_params"])
    kids = service.chunk_proofs(req.batch_data, req.task_id, req.chunk_count,
                                config["chain_id"], params, p["chunk_trace_rows"],
                                config["chunk_elems"], device=device)
    attest = (0, 1) if which is None else [k - 1 for k in which if k > 0]
    agg = service.aggregate(kids[0]["proof"], kids[1]["proof"], p["agg_queries"],
                            device=device, attest=attest)
    return pieces(agg, True)
