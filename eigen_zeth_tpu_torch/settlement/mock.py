"""In-memory settlement — hermetic stand-in for the L1 + bridge service.

The reference has no such backend (its integration tests require live
services, src/settlement/worker.rs:655-810); this one lets the whole
pipeline run and be tested in-process.  verify_batches actually verifies:
it parses the proof with the reference-parity codec and checks the
Groth16 pairing equation against the provided verifying key (the role the
EigenZkVM contract plays on-chain).

A copy of eigen_zeth_tpu/settlement/mock.py.  It verifies with the port's
host `groth16.verify` (python-int pairing); importing it builds and loads
no kernel."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional

from ..models import groth16
from ..ops import keccak
from .interface import BatchData, Settlement
from .proof_codec import parse_proof, parse_public_input


@dataclass
class VerifiedBatch:
    init_num_batch: int
    final_new_batch: int
    new_state_root: bytes


class MockSettlement(Settlement):
    def __init__(self, verifying_key: Optional[groth16.VerifyingKey] = None):
        self._lock = threading.Lock()
        self.vk = verifying_key
        self.sequenced: List[List[BatchData]] = []
        self.verified: List[VerifiedBatch] = []
        self.bridge_events: List[tuple] = []
        self.exit_roots: dict[int, bytes] = {}
        self.rollup_exit_root = b"\x00" * 32

    # -- bridge --------------------------------------------------------------

    def bridge_asset(self, destination_network, destination_address, amount,
                     token, force_update_global_exit_root, calldata):
        with self._lock:
            self.bridge_events.append(
                ("bridge_asset", destination_network, destination_address, amount, token)
            )

    def bridge_message(self, destination_network, destination_address,
                       force_update_global_exit_root, calldata):
        with self._lock:
            self.bridge_events.append(
                ("bridge_message", destination_network, destination_address)
            )

    def claim_asset(self, smt_proof, index, mainnet_exit_root, rollup_exit_root,
                    origin_network, origin_token_address, destination_network,
                    destination_address, amount, metadata):
        with self._lock:
            self.bridge_events.append(("claim_asset", index, amount))

    def claim_message(self, smt_proof, index, mainnet_exit_root, rollup_exit_root,
                      origin_network, origin_address, destination_network,
                      destination_address, amount, metadata):
        with self._lock:
            self.bridge_events.append(("claim_message", index, amount))

    # -- global exit root ----------------------------------------------------

    def update_exit_root(self, network, new_root):
        with self._lock:
            self.exit_roots[network] = bytes(new_root)
            self.rollup_exit_root = bytes(new_root)

    def get_global_exit_root(self) -> bytes:
        with self._lock:
            acc = b"".join(sorted(self.exit_roots.values())) or b"\x00" * 32
            return keccak.keccak256_host(acc)

    def get_last_rollup_exit_root(self) -> bytes:
        with self._lock:
            return self.rollup_exit_root

    # -- zkvm ----------------------------------------------------------------

    def sequence_batches(self, batches):
        with self._lock:
            self.sequenced.append(list(batches))

    def verify_batches(self, pending_state_num, init_num_batch, final_new_batch,
                       new_local_exit_root, new_state_root, proof, input):
        pi_abc = parse_proof(proof)  # reference-parity parse (may raise)
        pub = parse_public_input(input)
        if self.vk is not None:
            proof_dict = {
                "pi_a": {"x": str(pi_abc[0][0]), "y": str(pi_abc[0][1])},
                "pi_b": {
                    "x": [str(x) for x in pi_abc[1][0]],
                    "y": [str(x) for x in pi_abc[1][1]],
                },
                "pi_c": {"x": str(pi_abc[2][0]), "y": str(pi_abc[2][1])},
                "protocol": "groth16",
                "curve": "BN128",
            }
            if not groth16.verify(self.vk, proof_dict, pub):
                raise ValueError("groth16 verification failed")
        with self._lock:
            self.verified.append(
                VerifiedBatch(init_num_batch, final_new_batch, bytes(new_state_root))
            )

    def verify_batches_trusted_aggregator(self, pending_state_num, init_num_batch,
                                          final_new_batch, new_local_exit_root,
                                          new_state_root, proof, input):
        self.verify_batches(pending_state_num, init_num_batch, final_new_batch,
                            new_local_exit_root, new_state_root, proof, input)
