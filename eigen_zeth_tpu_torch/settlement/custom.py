"""Custom settlement — REST client to the bridge service.

Mirror of src/settlement/custom/{mod,methods}.rs: the same endpoint paths
(/bridge-asset, /bridge-message, /claim-asset, /claim-message,
/update-exit-root, /sequence-batches, /verify-batches,
/verify-batches-trusted-aggregator, /get-global-exit-root, /get-root),
JSON bodies, and the `status == 1` success convention (methods.rs:13,
87-99).

A copy of eigen_zeth_tpu/settlement/custom.py."""

from __future__ import annotations

import json
import urllib.request
from typing import List

from ..utils.config import global_env
from .interface import BatchData, Settlement


class CustomSettlement(Settlement):
    def __init__(self, bridge_service_addr: str | None = None, timeout: float = 10.0):
        self.url = (bridge_service_addr or global_env().bridge_service_addr).rstrip("/")
        self.timeout = timeout

    def _post(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            f"{self.url}/{path}",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            out = json.loads(resp.read())
        if out.get("status") != 1:  # methods.rs success convention
            raise RuntimeError(f"{path} failed: {out}")
        return out

    def _get(self, path: str) -> dict:
        with urllib.request.urlopen(f"{self.url}/{path}", timeout=self.timeout) as resp:
            out = json.loads(resp.read())
        if out.get("status") != 1:
            raise RuntimeError(f"{path} failed: {out}")
        return out

    # -- bridge --------------------------------------------------------------

    def bridge_asset(self, destination_network, destination_address, amount,
                     token, force_update_global_exit_root, calldata):
        self._post(
            "bridge-asset",
            {
                "destination_network": destination_network,
                "destination_address": destination_address,
                "amount": str(amount),
                "token": token,
                "force_update_global_exit_root": force_update_global_exit_root,
                "calldata": calldata.hex(),
            },
        )

    def bridge_message(self, destination_network, destination_address,
                       force_update_global_exit_root, calldata):
        self._post(
            "bridge-message",
            {
                "destination_network": destination_network,
                "destination_address": destination_address,
                "force_update_global_exit_root": force_update_global_exit_root,
                "calldata": calldata.hex(),
            },
        )

    def claim_asset(self, smt_proof, index, mainnet_exit_root, rollup_exit_root,
                    origin_network, origin_token_address, destination_network,
                    destination_address, amount, metadata):
        self._post(
            "claim-asset",
            {
                "smt_proof": [p.hex() for p in smt_proof],
                "index": index,
                "mainnet_exit_root": mainnet_exit_root.hex(),
                "rollup_exit_root": rollup_exit_root.hex(),
                "origin_network": origin_network,
                "origin_token_address": origin_token_address,
                "destination_network": destination_network,
                "destination_address": destination_address,
                "amount": str(amount),
                "metadata": metadata.hex(),
            },
        )

    def claim_message(self, smt_proof, index, mainnet_exit_root, rollup_exit_root,
                      origin_network, origin_address, destination_network,
                      destination_address, amount, metadata):
        self._post(
            "claim-message",
            {
                "smt_proof": [p.hex() for p in smt_proof],
                "index": index,
                "mainnet_exit_root": mainnet_exit_root.hex(),
                "rollup_exit_root": rollup_exit_root.hex(),
                "origin_network": origin_network,
                "origin_address": origin_address,
                "destination_network": destination_network,
                "destination_address": destination_address,
                "amount": str(amount),
                "metadata": metadata.hex(),
            },
        )

    # -- global exit root ----------------------------------------------------

    def update_exit_root(self, network, new_root):
        self._post(
            "update-exit-root",
            {"network": network, "new_root": new_root.hex()},
        )

    def get_global_exit_root(self) -> bytes:
        out = self._get("get-global-exit-root")
        return bytes.fromhex(out["global_exit_root"].removeprefix("0x"))

    def get_last_rollup_exit_root(self) -> bytes:
        out = self._get("get-root")
        return bytes.fromhex(out["rollup_exit_root"].removeprefix("0x"))

    # -- zkvm ----------------------------------------------------------------

    def sequence_batches(self, batches: List[BatchData]):
        self._post(
            "sequence-batches",
            {
                "batches": [
                    {
                        "transactions": b.transactions.hex(),
                        "global_exit_root": b.global_exit_root.hex(),
                        "timestamp": b.timestamp,
                    }
                    for b in batches
                ]
            },
        )

    def verify_batches(self, pending_state_num, init_num_batch, final_new_batch,
                       new_local_exit_root, new_state_root, proof, input):
        self._post(
            "verify-batches",
            {
                "pending_state_num": pending_state_num,
                "init_num_batch": init_num_batch,
                "final_new_batch": final_new_batch,
                "new_local_exit_root": new_local_exit_root.hex(),
                "new_state_root": new_state_root.hex(),
                "proof": proof,
                "input": input,
            },
        )

    def verify_batches_trusted_aggregator(self, pending_state_num, init_num_batch,
                                          final_new_batch, new_local_exit_root,
                                          new_state_root, proof, input):
        self._post(
            "verify-batches-trusted-aggregator",
            {
                "pending_state_num": pending_state_num,
                "init_num_batch": init_num_batch,
                "final_new_batch": final_new_batch,
                "new_local_exit_root": new_local_exit_root.hex(),
                "new_state_root": new_state_root.hex(),
                "proof": proof,
                "input": input,
            },
        )
