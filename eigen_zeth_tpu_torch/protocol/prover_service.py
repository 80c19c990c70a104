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

The final wrap is one of three circuits:
  "stark"   the node's default and the only sound wrap: step 3 attests
            every chunk in the wrap profile (Poseidon2-Fr commitments,
            models/air_wrap.py), and the Groth16 circuit verifies those
            attestation STARKs itself (models/wrap_circuit.py), so the
            final proof and its one public input alone imply the batch is
            valid.  The circuit is padded to `max_wrap_leaves` leaves, one
            shape per deployment, whose CRS is made once
            (`ensure_wrap_crs`) and persisted under `crs_dir`
            (models/crs.py).
  "mimc"    the aggregated digest MiMC-hashed in-circuit (~1.3k
            constraints); soundness rests on the aggregator's checks.
  "linear"  the 2-constraint packing wrap of the CPU test profiles.

As in the reference, every step returns COMPLETED_ERROR, with the error's
text, for anything that goes wrong in it: malformed input, an invalid
child proof, an executor's failure, and a kernel's build or launch failure
too (the caller sees the message; `chip_smoke.py` fails on it).
`ChainExecutor` is not ported yet (ROADMAP.md, Queue 1, M3).
"""

from __future__ import annotations

import base64
import functools
import json
import os
from dataclasses import dataclass
from typing import List, Optional

import torch

from ..models import crs as crs_mod
from ..models import groth16, recursion, stark, stark_batch, wrap_circuit
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
def _wrap_crs(wrap: str, seed: str, device: torch.device):
    """Groth16 CRS per (wrap circuit, seed, device), computed once per process."""
    if wrap == "mimc":
        r1cs = groth16.mimc_wrap_circuit().r1cs
    else:
        r1cs = groth16.wrap_circuit()
    pk, vk = groth16.setup(r1cs, seed=seed, device=device)
    return r1cs, pk, vk


class BatchProver:
    """The in-process prover engine on an explicit torch device.

    recursion: None turns recursive aggregation on whenever the chunk
    parameters fit the verifier AIR (blowup 4, a power-of-two query count,
    at least 8 trace rows, arity-2 FRI), as the JAX class does; it then
    fixes the chunk shape (4,096-row traces, 32 queries, terminal 64 unless
    given).  agg_queries: the query count of the attestation STARK itself.
    wrap_queries, wrap_grind_bits, wrap_blowup: the wrap-profile STARK's
    own soundness budget (conjectured bits = queries·log2(blowup/2) +
    grind; the node's default 11·4 + 12 = 56).  crs_dir: where the STARK
    wrap's CRS is persisted (the repo's artifacts/crs by default).
    max_wrap_leaves: the final circuit's fixed leaf count.  crs: an
    optional (r1cs, pk, vk) for the mimc / linear circuit (e.g. converted
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
        wrap_queries: int = 11,
        wrap_grind_bits: int = 12,
        wrap_blowup: int = 32,
        crs_dir: Optional[str] = None,
        max_wrap_leaves: int = 2,
        *,
        device: torch.device,
    ):
        if wrap not in ("stark", "mimc", "linear"):
            raise ValueError(f"unknown wrap circuit {wrap!r}")
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
        self.wrap_queries = wrap_queries
        self.wrap_grind_bits = wrap_grind_bits
        self.wrap_blowup = wrap_blowup
        self.crs_dir = crs_dir or os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            "artifacts", "crs",
        )
        self.max_wrap_leaves = max_wrap_leaves
        self.device = torch.device(device)
        self._groth16_seed = groth16_seed
        self._crs = crs
        self._stark_crs = {}  # shape key -> (pk, vk), loaded or generated
        self._padding_cache = None  # the canonical dummy wrap attestation

    def _groth16_crs(self):
        if self._crs is None:
            self._crs = _wrap_crs(self.wrap, self._groth16_seed, self.device)
        return self._crs

    @property
    def verifying_key(self) -> groth16.VerifyingKey:
        if self.wrap == "stark" and self._stark_crs:
            return next(iter(self._stark_crs.values()))[1]
        return self._groth16_crs()[2]

    # -- step 1 --------------------------------------------------------------

    def gen_batch_chunks(self, batch_id: str, block_numbers: List[int], chain_id: int,
                         program_name: str) -> GenBatchChunksResult:
        try:
            if not block_numbers:
                raise ValueError("empty block list")
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
        except Exception as e:  # the reference's COMPLETED_ERROR semantics
            return GenBatchChunksResult(
                batch_id=batch_id, task_id=make_task_id(block_numbers[0] if block_numbers else 0),
                result_code=ProofResultCode.COMPLETED_ERROR, chunk_count=0, batch_data="",
                pre_state_root=b"\x00" * 32, post_state_root=b"\x00" * 32,
                error_message=str(e),
            )

    # -- step 2 --------------------------------------------------------------

    def gen_chunk_proof(self, batch_id: str, task_id: str, chunk_count: int, chain_id: int,
                        program_name: str, batch_data: str) -> GenChunkProofResult:
        try:
            elems = bytes_to_field_elements(base64.b64decode(batch_data))
            chunks = [
                elems[i * self.chunk_elems : (i + 1) * self.chunk_elems]
                for i in range(chunk_count)
            ]
            ivs = [
                poseidon.hash_elements_host([chain_id, int(task_id), i])[0]
                for i in range(chunk_count)
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
        except Exception as e:
            return GenChunkProofResult(
                batch_id=batch_id, task_id=task_id,
                result_code=ProofResultCode.COMPLETED_ERROR, error_message=str(e),
            )

    # -- step 3 --------------------------------------------------------------

    def gen_aggregated_proof(self, batch_id: str, recursive_proof_1: str,
                             recursive_proof_2: str) -> GenAggregatedProofResult:
        """Aggregate two proofs and chain their digests.

        With recursion on, a chunk child is replaced by its attestation
        (in the wrap profile under the STARK wrap): an attestation of an
        invalid chunk proof cannot be built (the transcribed trace violates
        the verifier AIR and the prover's degree check fires), so this step
        is also the aggregator's validity check, and nobody downstream
        verifies the chunk proof again.  Any other child, and every child
        with recursion off, is verified on the host."""
        try:
            kids, digests = [], []
            for raw in (recursive_proof_1, recursive_proof_2):
                node = json.loads(raw)
                if self.recursion and node.get("type") == "chunk":
                    if self.wrap == "stark":
                        node = recursion.attest_chunk_wrap(
                            node["stark"], num_queries_wrap=self.wrap_queries,
                            grind_bits=self.wrap_grind_bits, ext_blowup=self.wrap_blowup,
                            device=self.device,
                        )
                    else:
                        node = recursion.attest_chunk(
                            node["stark"], num_queries_agg=self.agg_queries, device=self.device
                        )
                    digests.append(chunk_digest(node["header"]))
                else:
                    digests.append(self._validate(node))
                kids.append(node)
            digest = poseidon.hash_two_host(*digests)
            agg = {"type": "aggregated", "digest": [str(x) for x in digest], "children": kids}
            return GenAggregatedProofResult(
                batch_id=batch_id, result_code=ProofResultCode.COMPLETED_OK,
                result_string=json.dumps(agg),
            )
        except Exception as e:
            return GenAggregatedProofResult(
                batch_id=batch_id, result_code=ProofResultCode.COMPLETED_ERROR,
                error_message=str(e),
            )

    def _validate(self, node: dict) -> List[int]:
        """Verify a chunk, attested or aggregated proof; return its digest,
        or raise.  An attested chunk is checked through its attestation
        STARK alone, with the query count, the trace size and the terminal
        (and in the wrap profile the wrap's own queries and grind bits)
        pinned to the protocol's: they are fields of the attestation that
        an attacker could shrink."""
        kind = node.get("type")
        if kind == "chunk":
            if not stark.verify_chunk(node["stark"], self.stark_params):
                raise ValueError("invalid chunk proof")
            return chunk_digest(node["stark"])
        if kind == "aggregated":
            d1 = self._validate(node["children"][0])
            d2 = self._validate(node["children"][1])
            digest = poseidon.hash_two_host(d1, d2)
            if [str(x) for x in digest] != node["digest"]:
                raise ValueError("aggregated digest mismatch")
            return digest
        if kind in ("chunk-attested", "chunk-attested-wrap"):
            rows = self.chunk_trace_rows
            if rows is None:
                raise ValueError("no fixed chunk shape to pin the attestation to")
            kw = dict(
                expected_queries=self.stark_params.num_queries,
                expected_rows=rows,
                expected_terminal=self._pinned_terminal(),
            )
            if kind == "chunk-attested-wrap":
                return recursion.verify_attestation_wrap(
                    node, expected_wrap_queries=self.wrap_queries,
                    expected_wrap_grind=self.wrap_grind_bits, wrap_blowup=self.wrap_blowup,
                    device=self.device, **kw,
                )
            return recursion.verify_attestation(node, **kw)
        raise ValueError(f"unknown recursive proof type {kind!r}")

    # -- step 4 --------------------------------------------------------------

    def gen_final_proof(self, batch_id: str, recursive_proof: str, curve_name: str,
                        aggregator_addr: str) -> GenFinalProofResult:
        try:
            if curve_name.upper() not in ("BN128", "BN254"):
                raise ValueError(f"unsupported curve {curve_name!r}")
            if debug_proof_enabled():
                final = FinalProof(
                    proof=json.dumps(REFERENCE_PROOF),
                    public_input=json.dumps(REFERENCE_PUBLIC_INPUT),
                )
            elif self.wrap == "stark":
                final = self._gen_final_proof_stark(recursive_proof, aggregator_addr)
            else:
                final = self._gen_final_proof_digest(recursive_proof, aggregator_addr)
            return GenFinalProofResult(
                batch_id=batch_id, result_code=ProofResultCode.COMPLETED_OK, final_proof=final
            )
        except Exception as e:
            return GenFinalProofResult(
                batch_id=batch_id, result_code=ProofResultCode.COMPLETED_ERROR,
                error_message=str(e),
            )

    def _gen_final_proof_digest(self, recursive_proof: str, aggregator_addr: str) -> FinalProof:
        """The mimc / linear wrap: validate, then bind the digest and the
        aggregator address in the Groth16 public input."""
        digest = self._validate(json.loads(recursive_proof))
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
        return FinalProof(proof=json.dumps(proof), public_input=json.dumps([str(pub)]))

    def _gen_final_proof_stark(self, recursive_proof: str, aggregator_addr: str) -> FinalProof:
        """The sound final wrap: the Groth16 circuit verifies every child
        wrap-profile attestation STARK in-circuit and binds their statement
        hashes and the aggregator address into its single public input; no
        host validation sits in the verification path.  Building the
        circuit is the aggregation check: an invalid attestation gives
        unsatisfiable wires and raises there."""
        node = json.loads(recursive_proof)

        def leaves(n: dict) -> list:
            """The wrap-profile attestation leaves of the aggregation tree."""
            if n.get("type") == "chunk-attested-wrap":
                return [n]
            if n.get("type") == "aggregated":
                return [leaf for c in n["children"] for leaf in leaves(c)]
            raise ValueError(
                f"stark wrap requires wrap-profile attestations (got {n.get('type')!r})"
            )

        if node.get("type") != "aggregated":
            raise ValueError("stark wrap expects an aggregated proof")
        entries = [self._wrap_entry(child) for child in leaves(node)]
        # pad to the fixed leaf count with the canonical dummy attestation,
        # so one circuit shape (and one pinned VK) covers every batch
        if len(entries) > self.max_wrap_leaves:
            raise ValueError(
                f"{len(entries)} wrap leaves > max_wrap_leaves={self.max_wrap_leaves} "
                "(regenerate the CRS for a larger pad)"
            )
        while len(entries) < self.max_wrap_leaves:
            entries.append(self._padding_entry())
        r1cs, witness, pub = wrap_circuit.build_final_circuit(
            entries, aggregator_addr, device=self.device)
        pk, vk = self._wrap_stark_crs(aggregator_addr)
        proof = groth16.prove(pk, r1cs, witness, device=self.device)
        if not groth16.verify(vk, proof, [pub]):
            raise RuntimeError("Groth16 self-check failed")
        return FinalProof(proof=json.dumps(proof), public_input=json.dumps([str(pub)]))

    # -- CRS lifecycle (stark wrap) ------------------------------------------

    def _pinned_terminal(self) -> int:
        return min(self.stark_params.terminal_size, 4 * self.chunk_trace_rows)

    def _wrap_entry(self, att: dict) -> tuple:
        """(air, wrap proof, publics, boundaries) of a wrap attestation,
        pinned to the protocol."""
        air, publics, bnds = recursion.wrap_attestation_instance(
            att,
            expected_queries=self.stark_params.num_queries,
            expected_rows=self.chunk_trace_rows,
            expected_terminal=self._pinned_terminal(),
            wrap_blowup=self.wrap_blowup,
        )
        return air, att["wrap_proof"], publics, bnds

    def _padding_entry(self):
        """The canonical dummy wrap attestation that pads the final circuit
        to max_wrap_leaves: a fixed all-zero chunk (data [], iv 0) proved and
        attested at the deployment's chunk shape.  Deterministic, so every
        prover and verifier derives the same padding statement hash.  Cached
        in-process and persisted beside the CRS."""
        if self._padding_cache is not None:
            return self._padding_cache
        p = self.stark_params
        pad_key = crs_mod.shape_key([
            "wrap-padding", str(self.chunk_trace_rows), str(p.blowup),
            str(p.num_queries), str(p.terminal_size), str(p.shift),
            str(self.wrap_queries), str(self.wrap_grind_bits),
            str(self.wrap_blowup),
        ])
        path = os.path.join(self.crs_dir, f"{pad_key}-padding.json")
        child = None
        if os.path.exists(path):
            with open(path) as f:
                child = json.load(f)
        if child is None:
            chunk = stark.prove_chunk([], 0, self.stark_params, n_rows=self.chunk_trace_rows,
                                      device=self.device)
            child = recursion.attest_chunk_wrap(
                chunk, num_queries_wrap=self.wrap_queries, grind_bits=self.wrap_grind_bits,
                ext_blowup=self.wrap_blowup, device=self.device,
            )
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                json.dump(child, f)
        self._padding_cache = self._wrap_entry(child)
        return self._padding_cache

    def _wrap_shape_key(self, aggregator_addr: str) -> str:
        """Directory key of the deployment's circuit shape: chunk params,
        wrap profile, pad count and aggregator address (the address rides
        the sponge's domain tag, so it is part of the constraint matrices)."""
        p = self.stark_params
        return crs_mod.shape_key([
            "stark-wrap-final", str(self.chunk_trace_rows), str(p.blowup),
            str(p.num_queries), str(p.terminal_size), str(p.shift),
            str(self.wrap_queries), str(self.wrap_grind_bits),
            str(self.wrap_blowup), str(self.max_wrap_leaves),
            aggregator_addr.lower(),
        ])

    def _wrap_stark_crs(self, aggregator_addr: str):
        """Load the persisted CRS of the deployment's shape, or generate and
        persist it once (ensure_wrap_crs); step 4 itself never runs setup."""
        key = self._wrap_shape_key(aggregator_addr)
        if key in self._stark_crs:
            return self._stark_crs[key]
        loaded = crs_mod.load(os.path.join(self.crs_dir, key), device=self.device)
        if loaded is None:
            loaded = self.ensure_wrap_crs(aggregator_addr)
        self._stark_crs[key] = loaded
        return loaded

    def ensure_wrap_crs(self, aggregator_addr: str):
        """Generate and persist the CRS of the deployment's circuit shape.
        The circuit is built from padding entries alone (the constraint
        layout depends only on the shape), so this runs at deploy time with
        no batch in hand."""
        shape_entries = [self._padding_entry()] * self.max_wrap_leaves
        r1cs, _, _ = wrap_circuit.build_final_circuit(
            shape_entries, aggregator_addr, device=self.device)
        pk, vk = crs_mod.generate(r1cs, seed=self._groth16_seed, device=self.device)
        del r1cs
        key = self._wrap_shape_key(aggregator_addr)
        crs_mod.save(os.path.join(self.crs_dir, key), pk, vk)
        self._stark_crs[key] = (pk, vk)
        return pk, vk

    def pinned_vk(self, aggregator_addr: str):
        """The settlement side's VK for this deployment: only vk.json."""
        return crs_mod.load_pinned_vk(
            os.path.join(self.crs_dir, self._wrap_shape_key(aggregator_addr))
        )
