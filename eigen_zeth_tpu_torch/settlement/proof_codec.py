"""Groth16 proof -> L1 verifier encoding (parity with the reference).

parse_proof / parse_public_input mirror src/settlement/ethereum/mod.rs:
445-481 exactly: decimal-string JSON -> (a: G1, b: G2 with coefficients in
file order — no swap — c: G1) and a single-element uint256 input array.
encode_verify_batches builds the EigenZkVM.verifyBatches calldata the
reference submits (contracts/EigenZkVM.json ABI; call site
src/settlement/ethereum/interfaces/zkvm.rs:70-130, fixed 5M gas).

A copy of eigen_zeth_tpu/settlement/proof_codec.py.
"""

from __future__ import annotations

import json

from . import abi

# ((uint256,uint256),(uint256[2],uint256[2]),(uint256,uint256))
PROOF_TYPE = (
    "tuple",
    [
        ("tuple", [("uint", 256), ("uint", 256)]),
        ("tuple", [("array", ("uint", 256), 2), ("array", ("uint", 256), 2)]),
        ("tuple", [("uint", 256), ("uint", 256)]),
    ],
)

VERIFY_BATCHES_SIG = (
    "verifyBatches(uint64,uint64,uint64,bytes32,bytes32,"
    "((uint256,uint256),(uint256[2],uint256[2]),(uint256,uint256)),uint256[1])"
)
VERIFY_BATCHES_TRUSTED_SIG = (
    "verifyBatchesTrustedAggregator(uint64,uint64,uint64,bytes32,bytes32,"
    "((uint256,uint256),(uint256[2],uint256[2]),(uint256,uint256)),uint256[1])"
)
SEQUENCE_BATCHES_SIG = "sequenceBatches((bytes,bytes32,uint64)[])"

GAS_LIMIT = 5_000_000  # reference: zkvm.rs:39,93,155


def parse_proof(json_str: str):
    """Reference parse_proof (ethereum/mod.rs:445-473): no coefficient
    reordering — pi_b arrays are used in file order."""
    v = json.loads(json_str)
    a = (int(v["pi_a"]["x"]), int(v["pi_a"]["y"]))
    b = (
        [int(v["pi_b"]["x"][0]), int(v["pi_b"]["x"][1])],
        [int(v["pi_b"]["y"][0]), int(v["pi_b"]["y"][1])],
    )
    c = (int(v["pi_c"]["x"]), int(v["pi_c"]["y"]))
    return (a, b, c)


def parse_public_input(json_str: str):
    """Reference parse_public_input (ethereum/mod.rs:475-481)."""
    v = json.loads(json_str)
    return [int(v[0])]


def encode_verify_batches(
    pending_state_num: int,
    init_num_batch: int,
    final_new_batch: int,
    new_local_exit_root: bytes,
    new_state_root: bytes,
    proof_json: str,
    input_json: str,
    trusted: bool = False,
) -> bytes:
    proof = parse_proof(proof_json)
    pub = parse_public_input(input_json)
    sig = VERIFY_BATCHES_TRUSTED_SIG if trusted else VERIFY_BATCHES_SIG
    return abi.encode_call(
        sig,
        [
            ("uint", 64),
            ("uint", 64),
            ("uint", 64),
            ("bytes32",),
            ("bytes32",),
            PROOF_TYPE,
            ("array", ("uint", 256), 1),
        ],
        [
            pending_state_num,
            init_num_batch,
            final_new_batch,
            new_local_exit_root,
            new_state_root,
            proof,
            pub,
        ],
    )


def encode_sequence_batches(batches) -> bytes:
    """batches: list of (transactions: bytes, global_exit_root: bytes32,
    timestamp: int) — reference BatchData (settlement/mod.rs:16-21)."""
    batch_type = ("tuple", [("bytes",), ("bytes32",), ("uint", 64)])
    return abi.encode_call(
        SEQUENCE_BATCHES_SIG,
        [("array", batch_type, None)],
        [[(b.transactions, b.global_exit_root, b.timestamp) for b in batches]],
    )
