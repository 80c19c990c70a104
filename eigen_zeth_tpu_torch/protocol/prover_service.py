"""The batch prover service — port of eigen_zeth_tpu/protocol/prover_service.py.

The four ProverService steps, as the eigen-zeth node drives them:

  gen_batch_chunks      execution payload -> chunk decomposition
  gen_chunk_proof       one STARK per chunk, all chunks batched on the
                        device (models/stark_batch.py)
  gen_aggregated_proof  with recursion on (the default where the chunk
                        shape allows it), every chunk child is replaced by a
                        verifier-AIR attestation STARK proved on the device
                        (models/recursion.py), and the children's digests
                        are chained; with recursion off, host `verify_chunk`
                        of both children and the digest chain
  gen_final_proof       validates the aggregated proof (attestations by the
                        host AIR verifier, with the protocol's query count,
                        trace size and terminal pinned), then the
                        Groth16/BN128 wrap of the digest (+ aggregator
                        address); the MSMs run on the device

The "mimc" and "linear" wraps are ported.  The in-circuit STARK wrap
(`wrap="stark"`, the Poseidon2-Fr side) and `ChainExecutor` are still to be
ported (ROADMAP.md, Queue 1, L4b); asking for them raises
NotImplementedError.

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

from ..models import groth16, recursion, stark, stark_batch
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

_NOT_PORTED = "not ported yet, the next slice of the port: see ROADMAP.md, Queue 1, L4b"

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

    recursion: None turns recursive aggregation on whenever the chunk
    parameters fit the verifier AIR (blowup 4, a power-of-two query count,
    at least 8 trace rows, arity-2 FRI), as the JAX class does; it then
    fixes the chunk shape (4,096-row traces, 32 queries, terminal 64 unless
    given).  agg_queries: the query count of the attestation STARK itself.
    crs: an optional (r1cs, pk, vk) for the wrap circuit (e.g. converted
    from the JAX package's setup); by default setup runs once per process."""

    def __init__(
        self,
        executor=None,
        stark_params: Optional[stark.StarkParams] = None,
        groth16_seed: str = "ezt-groth16-dev",
        recursion: Optional[bool] = None,
        chunk_trace_rows: Optional[int] = None,
        agg_queries: int = 30,
        wrap: str = "mimc",
        crs=None,
        *,
        device: torch.device,
    ):
        if wrap not in ("mimc", "linear"):
            raise NotImplementedError(f"wrap={wrap!r} is {_NOT_PORTED}")
        self.executor = executor or SyntheticExecutor()
        if recursion is None:
            n_rows = chunk_trace_rows or CHUNK_TRACE_ROWS
            nq = stark_params.num_queries if stark_params else 32
            recursion = stark_params is None or (
                stark_params.blowup == 4
                and n_rows >= 8
                and nq & (nq - 1) == 0
                and stark_params.fri_arity == 2
            )
        self.recursion = recursion
        self.agg_queries = agg_queries
        if recursion:
            # a uniform chunk shape, so that the verifier AIR is fixed per
            # (trace size, terminal, queries)
            self.chunk_trace_rows = chunk_trace_rows or CHUNK_TRACE_ROWS
            self.stark_params = stark_params or stark.StarkParams(
                blowup=4, num_queries=32, terminal_size=64
            )
            nq = self.stark_params.num_queries
            assert nq & (nq - 1) == 0, "recursion requires a power-of-two chunk query count"
            assert self.stark_params.fri_arity == 2, (
                "the verifier AIR arithmetizes arity-2 FRI only"
            )
        else:
            self.chunk_trace_rows = chunk_trace_rows
            self.stark_params = stark_params or stark.StarkParams()
        self.chunk_elems = (
            min(CHUNK_FIELD_ELEMS, self.chunk_trace_rows - 1)
            if self.chunk_trace_rows
            else CHUNK_FIELD_ELEMS
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
        """Aggregate two proofs and chain their digests.

        With recursion on, a chunk child is replaced by its attestation: an
        attestation of an invalid chunk proof cannot be built (the
        transcribed trace violates the verifier AIR and the prover's degree
        check fires), so this step is also the aggregator's validity check,
        and nobody downstream verifies the chunk proof again.  Any other
        child, and every child with recursion off, is verified on the host."""
        kids, digests = [], []
        for raw in (recursive_proof_1, recursive_proof_2):
            node = json.loads(raw)
            if self.recursion and node.get("type") == "chunk":
                try:
                    node = recursion.attest_chunk(
                        node["stark"], num_queries_agg=self.agg_queries, device=self.device
                    )
                except (AssertionError, KeyError, IndexError):
                    # an invalid chunk proof (the transcription's own checks
                    # or the prover's degree check) or one with parts
                    # missing.  A kernel wrapper refuses its input with
                    # ValueError / TypeError and a failing launch raises
                    # RuntimeError: none of them is caught
                    digests.append(None)
                    continue
                digests.append(chunk_digest(node["header"]))
            else:
                digests.append(self._validate(node))
            kids.append(node)
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
        """Verify a chunk, attested or aggregated proof; its digest, or None
        if invalid.  An attested chunk is checked through its verifier-AIR
        STARK alone, with the query count, the trace size and the terminal
        pinned to the protocol's: they are fields of the attestation that
        an attacker could shrink."""
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
        if kind == "chunk-attested":
            rows = self.chunk_trace_rows
            if rows is None:  # no fixed chunk shape to pin the attestation to
                return None
            try:
                return recursion.verify_attestation(
                    node,
                    expected_queries=self.stark_params.num_queries,
                    expected_rows=rows,
                    expected_terminal=min(self.stark_params.terminal_size, 4 * rows),
                )
            except (AssertionError, KeyError, ValueError, TypeError, IndexError):
                return None  # host code only: no kernel's error can hide here
        if kind == "chunk-attested-wrap":
            raise NotImplementedError(f"wrap-profile attestations are {_NOT_PORTED}")
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
