"""Prover protocol messages — copy of the result dataclasses of
eigen_zeth_tpu/protocol/messages.py (the ProverService steps' results and
the task id convention), so the port imports nothing of the JAX package."""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import List, Optional


class ProofResultCode(IntEnum):  # prover.proto:153-156
    COMPLETED_OK = 0
    COMPLETED_ERROR = 1


def make_task_id(batch: int) -> str:
    """prover.proto:49-54: zero-pad the batch number to 10 characters."""
    return str(int(batch)).zfill(10)


# --- GenBatchProof step 1: chunk the batch (prover.proto:49-66) ------------


@dataclass
class GenBatchChunksResult:  # prover.proto:80-91
    batch_id: str
    task_id: str
    result_code: ProofResultCode
    chunk_count: int
    batch_data: str
    pre_state_root: bytes
    post_state_root: bytes
    error_message: str = ""


# --- GenBatchProof step 2: prove each chunk (prover.proto:56-66,93-111) ----


@dataclass
class ChunkProof:  # prover.proto:107-111
    chunk_id: int
    proof_key: str
    proof: str


@dataclass
class GenChunkProofResult:  # prover.proto:93-105
    batch_id: str
    task_id: str
    result_code: ProofResultCode
    chunk_proofs: List[ChunkProof] = field(default_factory=list)
    error_message: str = ""


# --- aggregation (prover.proto:115-126) ------------------------------------


@dataclass
class GenAggregatedProofResult:
    batch_id: str
    result_code: ProofResultCode
    result_string: str = ""  # the recursive proof
    error_message: str = ""


# --- final proof (prover.proto:130-148) ------------------------------------


@dataclass
class FinalProof:  # prover.proto:145-148
    proof: str
    public_input: str


@dataclass
class GenFinalProofResult:
    batch_id: str
    result_code: ProofResultCode
    result_string: str = ""
    final_proof: Optional[FinalProof] = None
    error_message: str = ""
