"""Resumable 4-phase proving pipeline — copy of
eigen_zeth_tpu/protocol/state_machine.py, the reference's ProverChannel
state machine around a prover with the four `BatchProver` steps (the
port's in-process `BatchProver`, or `grpc_shim.RemoteBatchProver` on the
node side of the wire).

Reference: src/prover/provider.rs:100-107 (steps Start → Batch(GenChunk →
GenProof) → Aggregate → Final → End), provider.rs:232-241 (step record
persisted on every transition), provider.rs:245-274 (record reload +
validation on entry for crash resume), provider.rs:332-348 (error →
retry the same step), provider.rs:528-539 (End clears the record and
yields the ProofResult).

Differences from the reference, as in the JAX package:
  * intermediate artifacts (chunk result, chunk proofs, aggregation
    nodes) are checkpointed alongside the step tag, so resume never
    recomputes a finished phase;
  * aggregation folds ALL chunk proofs in a pairwise binary tree (the
    reference client forwards only first+last to its server,
    provider.rs:384-390, because the real tree lives server-side).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

from ..utils.config import global_env
from .kv import KEY_PROVE_STEP_RECORD, Database, ProofResult
from .messages import ProofResultCode
from .prover_service import BatchProver

STEP_START = "Start"
STEP_CHUNKS = "GenChunks"
STEP_CHUNK_PROOF = "GenChunkProof"
STEP_AGGREGATE = "Aggregate"
STEP_FINAL = "Final"
STEP_END = "End"

_ORDER = [STEP_START, STEP_CHUNKS, STEP_CHUNK_PROOF, STEP_AGGREGATE, STEP_FINAL, STEP_END]


class ProverError(RuntimeError):
    pass


@dataclass
class StepRecord:
    block_number: int
    step: str
    state: dict

    def to_json(self) -> str:
        return json.dumps(
            {"block_number": self.block_number, "step": self.step, "state": self.state}
        )

    @classmethod
    def from_json(cls, raw: str) -> "StepRecord":
        d = json.loads(raw)
        return cls(int(d["block_number"]), d["step"], d.get("state", {}))


class ProverPipeline:
    """Drives one batch (block) through the four proving phases."""

    def __init__(
        self,
        db: Database,
        prover: BatchProver,
        chain_id: Optional[int] = None,
        program_name: Optional[str] = None,
        aggregator_addr: str = "",
        max_retries: int = 3,
    ):
        env = global_env()
        self.db = db
        self.prover = prover
        self.chain_id = chain_id if chain_id is not None else env.chain_id
        self.program_name = program_name or env.program_name
        self.curve_name = env.curve_type
        self.aggregator_addr = aggregator_addr
        self.max_retries = max_retries

    # -- step record (provider.rs:232-274 semantics) ------------------------

    def _save(self, rec: StepRecord) -> None:
        self.db.put(KEY_PROVE_STEP_RECORD, rec.to_json().encode())

    def _load(self, block_number: int) -> StepRecord:
        raw = self.db.get(KEY_PROVE_STEP_RECORD)
        if raw is None:
            return StepRecord(block_number, STEP_START, {})
        rec = StepRecord.from_json(raw.decode())
        if rec.block_number != block_number:
            # a stale record from another batch: restart this batch clean
            # (mirrors the reference's batch-mismatch reset, provider.rs:256-266)
            return StepRecord(block_number, STEP_START, {})
        return rec

    def _clear(self) -> None:
        self.db.delete(KEY_PROVE_STEP_RECORD)

    # -- the state machine ---------------------------------------------------

    def execute(self, block_number: int) -> ProofResult:
        rec = self._load(block_number)
        batch_id = f"batch-{block_number}"
        retries = 0
        while rec.step != STEP_END:
            try:
                rec = self._advance(rec, batch_id)
                self._save(rec)
                retries = 0
            except ProverError:
                retries += 1
                if retries > self.max_retries:
                    raise
        result = ProofResult(
            block_number=block_number,
            proof=rec.state["final_proof"],
            public_input=rec.state["public_input"],
            pre_state_root=bytes(rec.state["pre_state_root"]),
            post_state_root=bytes(rec.state["post_state_root"]),
        )
        self._clear()
        return result

    def _advance(self, rec: StepRecord, batch_id: str) -> StepRecord:
        n = rec.block_number
        s = dict(rec.state)
        if rec.step == STEP_START:
            return StepRecord(n, STEP_CHUNKS, s)

        if rec.step == STEP_CHUNKS:
            res = self.prover.gen_batch_chunks(
                batch_id, [n], self.chain_id, self.program_name
            )
            if res.result_code != ProofResultCode.COMPLETED_OK:
                raise ProverError(res.error_message)
            s.update(
                task_id=res.task_id,
                chunk_count=res.chunk_count,
                batch_data=res.batch_data,
                pre_state_root=list(res.pre_state_root),
                post_state_root=list(res.post_state_root),
            )
            return StepRecord(n, STEP_CHUNK_PROOF, s)

        if rec.step == STEP_CHUNK_PROOF:
            res = self.prover.gen_chunk_proof(
                batch_id,
                s["task_id"],
                s["chunk_count"],
                self.chain_id,
                self.program_name,
                s["batch_data"],
            )
            if res.result_code != ProofResultCode.COMPLETED_OK:
                raise ProverError(res.error_message)
            s["chunk_proofs"] = [cp.proof for cp in res.chunk_proofs]
            return StepRecord(n, STEP_AGGREGATE, s)

        if rec.step == STEP_AGGREGATE:
            proofs = list(s["chunk_proofs"])
            while len(proofs) > 1:
                nxt = []
                for i in range(0, len(proofs) - 1, 2):
                    res = self.prover.gen_aggregated_proof(
                        batch_id, proofs[i], proofs[i + 1]
                    )
                    if res.result_code != ProofResultCode.COMPLETED_OK:
                        raise ProverError(res.error_message)
                    nxt.append(res.result_string)
                if len(proofs) % 2:
                    nxt.append(proofs[-1])
                proofs = nxt
            if len(proofs) == 1 and json.loads(proofs[0]).get("type") == "chunk":
                # single chunk: aggregate it with itself so the final wrap
                # always consumes an aggregation node (reference behavior:
                # first == last chunk proof, provider.rs:384-390)
                res = self.prover.gen_aggregated_proof(batch_id, proofs[0], proofs[0])
                if res.result_code != ProofResultCode.COMPLETED_OK:
                    raise ProverError(res.error_message)
                proofs = [res.result_string]
            s["recursive_proof"] = proofs[0]
            return StepRecord(n, STEP_FINAL, s)

        if rec.step == STEP_FINAL:
            res = self.prover.gen_final_proof(
                batch_id, s["recursive_proof"], self.curve_name, self.aggregator_addr
            )
            if res.result_code != ProofResultCode.COMPLETED_OK or res.final_proof is None:
                raise ProverError(res.error_message)
            s["final_proof"] = res.final_proof.proof
            s["public_input"] = res.final_proof.public_input
            # drop bulky intermediates from the terminal record
            s.pop("chunk_proofs", None)
            s.pop("recursive_proof", None)
            s.pop("batch_data", None)
            return StepRecord(n, STEP_END, s)

        raise ProverError(f"unknown step {rec.step!r}")
