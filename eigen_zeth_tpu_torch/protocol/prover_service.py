"""The batch prover service — port of eigen_zeth_tpu/protocol/prover_service.py.

The four ProverService steps, as the eigen-zeth node drives them:

  gen_batch_chunks      execution payload -> chunk decomposition
  gen_chunk_proof       one STARK per chunk, all chunks batched on the
                        device (models/stark_batch.py)
  gen_aggregated_proof  host `verify_chunk` of both children and a Poseidon
                        digest of their commitments
  gen_final_proof       Groth16/BN128 wrap of the digest (+ aggregator
                        address); the MSMs run on the device

This slice covers `recursion=False` with the "mimc" and "linear" wraps.
Recursion, the in-circuit STARK wrap and `ChainExecutor` are still to be
ported (ROADMAP.md, Queue 1); asking for them raises NotImplementedError.

Failures the protocol expects (unsupported curve, an invalid child proof,
no blocks) come back as COMPLETED_ERROR results.  Anything else — a kernel
build or launch failure among them — raises.
"""

from __future__ import annotations

import base64
import functools
import json
import os
from dataclasses import dataclass
from typing import List, Optional

import torch

from ..models import groth16, stark, stark_batch
from ..ops import keccak, poseidon
from .messages import (
    ChunkProof,
    FinalProof,
    GenAggregatedProofResult,
    GenBatchChunksResult,
    GenChunkProofResult,
    GenFinalProofResult,
    ProofResultCode,
    make_task_id,
)

CHUNK_FIELD_ELEMS = 4094  # data elements per chunk (< one trace of 4096)
CHUNK_TRACE_ROWS = 4096

_NOT_PORTED = "not ported yet: see ROADMAP.md, Queue 1 (recursion, the STARK wrap)"

# The canned reference proof that DEBUG_PROOF=TRUE stamps on every batch
# (the same values as eigen_zeth_tpu/protocol/vectors.py).
REFERENCE_PROOF = {
    "pi_a": {
        "x": "17417480591305158925649477501478755112960263076414890363431950352106756703156",
        "y": "3861645839258872471588434820677153286443622533258823533716073415753807193362",
    },
    "pi_b": {
        "x": [
            "1888192340250615284162548953478000113552765573288627153885483983991945077778",
            "12839537089607918006526648939966606447200305496614910310480973165133791671186",
        ],
        "y": [
            "9356128563962693123369145196078200120594297064426889980828801354429599038284",
            "8356895530159769835834895094470393417156532106130004017665561138310422920909",
        ],
    },
    "pi_c": {
        "x": "4689980742433253475969746726233113733646868104702109866973549391946972020034",
        "y": "7120799072200037615976388306327185991018815509189704120496254138703976052472",
    },
    "protocol": "groth16",
    "curve": "BN128",
}
REFERENCE_PUBLIC_INPUT = [
    "14190879858911742134402832400201910146341202868841835779272582838585145689449"
]


@dataclass
class ExecutionResult:
    batch_data: bytes
    pre_state_root: bytes
    post_state_root: bytes


class SyntheticExecutor:
    """Deterministic stand-in for the L2 execution layer: per-block payloads
    and keccak-chained state roots derived from block numbers."""

    def execute(self, block_numbers: List[int], chain_id: int) -> ExecutionResult:
        payload = b"".join(
            keccak.keccak256_host(f"ezt-block/{chain_id}/{b}".encode()) for b in block_numbers
        )
        pre = keccak.keccak256_host(f"ezt-state/{chain_id}/{min(block_numbers) - 1}".encode())
        post = keccak.keccak256_host(f"ezt-state/{chain_id}/{max(block_numbers)}".encode())
        return ExecutionResult(pre + post + payload, pre, post)


def bytes_to_field_elements(data: bytes) -> List[int]:
    """Pack 7 bytes per Goldilocks element (2^56 < p): injective, simple."""
    return [int.from_bytes(data[off : off + 7], "little") for off in range(0, len(data), 7)]


def chunk_digest(proof: dict) -> List[int]:
    """Commitment digest of a chunk proof: its public values and trace root."""
    vals = [
        int(proof["n"]),
        int(proof["public"]["iv"]),
        int(proof["public"]["out"]),
        int(proof["public"]["gamma"]),
    ] + [int(x) for x in proof["trace_root"]]
    return poseidon.hash_elements_host(vals)


def debug_proof_enabled() -> bool:
    return os.environ.get("DEBUG_PROOF", "").upper() == "TRUE"


@functools.lru_cache(maxsize=4)
def _wrap_crs(wrap: str, seed: str):
    """Groth16 CRS per (wrap circuit, seed), computed once per process."""
    if wrap == "mimc":
        r1cs = groth16.mimc_wrap_circuit().r1cs
    else:
        r1cs = groth16.wrap_circuit()
    pk, vk = groth16.setup(r1cs, seed=seed)
    return r1cs, pk, vk


class BatchProver:
    """The in-process prover engine on an explicit torch device.

    crs: an optional (r1cs, pk, vk) for the wrap circuit (e.g. converted
    from the JAX package's setup); by default setup runs once per process."""

    def __init__(
        self,
        executor=None,
        stark_params: Optional[stark.StarkParams] = None,
        groth16_seed: str = "ezt-groth16-dev",
        recursion: bool = False,
        chunk_trace_rows: Optional[int] = None,
        wrap: str = "mimc",
        crs=None,
        *,
        device: torch.device,
    ):
        if recursion:
            raise NotImplementedError(f"recursive aggregation is {_NOT_PORTED}")
        if wrap not in ("mimc", "linear"):
            raise NotImplementedError(f"wrap={wrap!r} is {_NOT_PORTED}")
        self.executor = executor or SyntheticExecutor()
        self.stark_params = stark_params or stark.StarkParams()
        self.chunk_trace_rows = chunk_trace_rows
        self.chunk_elems = (
            min(CHUNK_FIELD_ELEMS, chunk_trace_rows - 1) if chunk_trace_rows else CHUNK_FIELD_ELEMS
        )
        self.wrap = wrap
        self.device = torch.device(device)
        self._groth16_seed = groth16_seed
        self._crs = crs

    def _groth16_crs(self):
        if self._crs is None:
            self._crs = _wrap_crs(self.wrap, self._groth16_seed)
        return self._crs

    @property
    def verifying_key(self) -> groth16.VerifyingKey:
        return self._groth16_crs()[2]

    # -- step 1 --------------------------------------------------------------

    def gen_batch_chunks(self, batch_id: str, block_numbers: List[int], chain_id: int,
                         program_name: str) -> GenBatchChunksResult:
        if not block_numbers:
            return GenBatchChunksResult(
                batch_id=batch_id, task_id=make_task_id(0),
                result_code=ProofResultCode.COMPLETED_ERROR, chunk_count=0, batch_data="",
                pre_state_root=b"\x00" * 32, post_state_root=b"\x00" * 32,
                error_message="empty block list",
            )
        ex = self.executor.execute(block_numbers, chain_id)
        elems = bytes_to_field_elements(ex.batch_data)
        return GenBatchChunksResult(
            batch_id=batch_id,
            task_id=make_task_id(block_numbers[0]),
            result_code=ProofResultCode.COMPLETED_OK,
            chunk_count=max(1, -(-len(elems) // self.chunk_elems)),
            batch_data=base64.b64encode(ex.batch_data).decode(),
            pre_state_root=ex.pre_state_root,
            post_state_root=ex.post_state_root,
        )

    # -- step 2 --------------------------------------------------------------

    def gen_chunk_proof(self, batch_id: str, task_id: str, chunk_count: int, chain_id: int,
                        program_name: str, batch_data: str) -> GenChunkProofResult:
        elems = bytes_to_field_elements(base64.b64decode(batch_data))
        chunks = [
            elems[i * self.chunk_elems : (i + 1) * self.chunk_elems] for i in range(chunk_count)
        ]
        ivs = [
            poseidon.hash_elements_host([chain_id, int(task_id), i])[0] for i in range(chunk_count)
        ]
        starks = stark_batch.prove_chunks(
            chunks, ivs, self.stark_params, n=self.chunk_trace_rows, device=self.device
        )
        proofs = [
            ChunkProof(
                chunk_id=i,
                proof_key=f"{task_id}/{i}",
                proof=json.dumps({"type": "chunk", "stark": proof}),
            )
            for i, proof in enumerate(starks)
        ]
        return GenChunkProofResult(
            batch_id=batch_id, task_id=task_id,
            result_code=ProofResultCode.COMPLETED_OK, chunk_proofs=proofs,
        )

    # -- step 3 --------------------------------------------------------------

    def gen_aggregated_proof(self, batch_id: str, recursive_proof_1: str,
                             recursive_proof_2: str) -> GenAggregatedProofResult:
        """Aggregate two proofs: host-verify each child, chain the digests."""
        kids = [json.loads(raw) for raw in (recursive_proof_1, recursive_proof_2)]
        digests = [self._validate(kid) for kid in kids]
        if None in digests:
            return GenAggregatedProofResult(
                batch_id=batch_id, result_code=ProofResultCode.COMPLETED_ERROR,
                error_message="invalid child proof",
            )
        digest = poseidon.hash_two_host(*digests)
        agg = {"type": "aggregated", "digest": [str(x) for x in digest], "children": kids}
        return GenAggregatedProofResult(
            batch_id=batch_id, result_code=ProofResultCode.COMPLETED_OK,
            result_string=json.dumps(agg),
        )

    def _validate(self, node: dict) -> Optional[List[int]]:
        """Verify a chunk or aggregated proof; its digest, or None if invalid."""
        kind = node.get("type")
        if kind == "chunk":
            if not stark.verify_chunk(node["stark"], self.stark_params):
                return None
            return chunk_digest(node["stark"])
        if kind == "aggregated":
            d = [self._validate(c) for c in node["children"]]
            if None in d:
                return None
            digest = poseidon.hash_two_host(*d)
            return digest if [str(x) for x in digest] == node["digest"] else None
        if kind in ("chunk-attested", "chunk-attested-wrap"):
            raise NotImplementedError(f"attested children are {_NOT_PORTED}")
        return None

    # -- step 4 --------------------------------------------------------------

    def gen_final_proof(self, batch_id: str, recursive_proof: str, curve_name: str,
                        aggregator_addr: str) -> GenFinalProofResult:
        def error(msg: str) -> GenFinalProofResult:
            return GenFinalProofResult(
                batch_id=batch_id, result_code=ProofResultCode.COMPLETED_ERROR, error_message=msg
            )

        if curve_name.upper() not in ("BN128", "BN254"):
            return error(f"unsupported curve {curve_name!r}")
        if debug_proof_enabled():
            final = FinalProof(
                proof=json.dumps(REFERENCE_PROOF), public_input=json.dumps(REFERENCE_PUBLIC_INPUT)
            )
            return GenFinalProofResult(
                batch_id=batch_id, result_code=ProofResultCode.COMPLETED_OK, final_proof=final
            )
        digest = self._validate(json.loads(recursive_proof))
        if digest is None:
            return error("invalid recursive proof")
        # bind the aggregator address into the wrapped digest
        bound = poseidon.hash_elements_host(
            digest + bytes_to_field_elements(aggregator_addr.encode())
        )
        r1cs, pk, vk = self._groth16_crs()
        if self.wrap == "mimc":
            witness, pub = groth16.mimc_wrap_witness(bound)
        else:
            witness, pub = groth16.wrap_witness(bound)
        proof = groth16.prove(pk, r1cs, witness, device=self.device)
        if not groth16.verify(vk, proof, [pub]):
            raise RuntimeError("Groth16 self-check failed")
        final = FinalProof(proof=json.dumps(proof), public_input=json.dumps([str(pub)]))
        return GenFinalProofResult(
            batch_id=batch_id, result_code=ProofResultCode.COMPLETED_OK, final_proof=final
        )
