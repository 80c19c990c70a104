"""Ethereum settlement — contract calldata over raw JSON-RPC.

Mirror of src/settlement/ethereum/mod.rs: the same TOML config shape
(configs/settlement.toml), the four contract clients
(interfaces/{bridge,zkvm,global_exit_root,zeth_global_exit_root}.rs with
identical function signatures), the 5M fixed gas on zkvm txs
(zkvm.rs:39,93,155), and the parse_proof/parse_public_input encoding path
(mod.rs:338-394).

Transport: stdlib urllib JSON-RPC.  With a configured local wallet
(local_wallet.private_key, mirroring the reference's ethers
LocalWallet, mod.rs:97-120), transactions are EIP-155 signed in-process
(utils/ethtx), sent via eth_sendRawTransaction with node-queried nonces,
and receipt-polled — so settlement works against any stock JSON-RPC
node.  Without a key it falls back to eth_sendTransaction (node-managed
keys, the dev-net pattern).  eth_call serves the view methods.

A copy of eigen_zeth_tpu/settlement/ethereum.py.  The chain executor of the
port's prover server reads the L2 through its `JsonRpcClient`.
"""

from __future__ import annotations

import json
import time
import tomllib
import urllib.request
from dataclasses import dataclass
from typing import Optional

from ..utils import ethtx, secp256k1
from . import abi
from .interface import BatchData, Settlement
from .proof_codec import (
    GAS_LIMIT,
    encode_sequence_batches,
    encode_verify_batches,
)


class JsonRpcClient:
    """Minimal JSON-RPC 2.0 over HTTP (ethers-providers analog)."""

    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url
        self.timeout = timeout
        self._id = 0

    def call(self, method: str, params: list):
        self._id += 1
        payload = json.dumps(
            {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
        ).encode()
        req = urllib.request.Request(
            self.url, data=payload, headers={"Content-Type": "application/json"}
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            out = json.loads(resp.read())
        if "error" in out:
            raise RuntimeError(f"rpc error: {out['error']}")
        return out.get("result")

    def block_number(self) -> int:
        return int(self.call("eth_blockNumber", []), 16)

    def get_block_by_number(self, number, full_txs: bool = False):
        tag = hex(number) if isinstance(number, int) else number
        return self.call("eth_getBlockByNumber", [tag, full_txs])

    def send_transaction(self, tx: dict) -> str:
        return self.call("eth_sendTransaction", [tx])

    def send_raw_transaction(self, raw: bytes) -> str:
        return self.call("eth_sendRawTransaction", ["0x" + raw.hex()])

    def get_transaction_count(self, addr: str, tag: str = "pending") -> int:
        return int(self.call("eth_getTransactionCount", [addr, tag]), 16)

    def gas_price(self) -> int:
        return int(self.call("eth_gasPrice", []), 16)

    def chain_id(self) -> int:
        return int(self.call("eth_chainId", []), 16)

    def get_transaction_receipt(self, tx_hash: str):
        return self.call("eth_getTransactionReceipt", [tx_hash])

    def eth_call(self, to: str, data: bytes) -> bytes:
        out = self.call("eth_call", [{"to": to, "data": "0x" + data.hex()}, "latest"])
        return bytes.fromhex(out[2:]) if out and out.startswith("0x") else b""


@dataclass
class EthereumSettlementConfig:
    """configs/settlement.toml mirror (reference: ethereum/mod.rs:30-76)."""

    provider_url: str
    local_account: str  # sending address (derived from the key when set)
    l1_contracts_addr: dict  # bridge / global_exit_root / zkvm
    l2_contracts_addr: dict  # zeth global exit root
    zeth_config: Optional[dict] = None
    private_key: Optional[int] = None  # local wallet (mod.rs:97-120)
    receipt_timeout: float = 30.0  # seconds to poll for tx receipts

    @classmethod
    def from_conf_path(cls, path: str) -> "EthereumSettlementConfig":
        with open(path, "rb") as f:
            conf = tomllib.load(f)
        eth = conf.get("ethereum_settlement_config", conf)
        wallet = eth.get("local_wallet", {})
        key_hex = wallet.get("private_key") or eth.get("private_key")
        priv = int(key_hex, 16) if key_hex else None
        addr = wallet.get("address") or eth.get("local_account")
        if priv is not None:
            addr = secp256k1.priv_to_address(priv)
        return cls(
            provider_url=eth["provider_url"],
            local_account=addr or "0x" + "00" * 20,
            l1_contracts_addr=eth["l1_contracts_addr"],
            l2_contracts_addr=eth.get("l2_contracts_addr", {}),
            zeth_config=eth.get("zeth_config"),
            private_key=priv,
            receipt_timeout=float(eth.get("receipt_timeout", 30.0)),
        )


class EthereumSettlement(Settlement):
    def __init__(self, config: EthereumSettlementConfig):
        self.cfg = config
        self.l1 = JsonRpcClient(config.provider_url)
        zeth_url = (config.zeth_config or {}).get("provider_url")
        self.l2 = JsonRpcClient(zeth_url) if zeth_url else self.l1
        self._chain_id: Optional[int] = None
        self._nonce: Optional[int] = None  # local allocator over node base

    # -- tx plumbing ---------------------------------------------------------

    def _send(self, to: str, data: bytes, gas: int = GAS_LIMIT) -> str:
        if self.cfg.private_key is None:
            # node-managed keys (dev-net pattern)
            return self.l1.send_transaction(
                {
                    "from": self.cfg.local_account,
                    "to": to,
                    "gas": hex(gas),
                    "data": "0x" + data.hex(),
                }
            )
        return self._send_signed(to, data, gas)

    def _send_signed(self, to: str, data: bytes, gas: int) -> str:
        """Local-wallet path (ethereum/mod.rs:97-161): sign EIP-155,
        eth_sendRawTransaction, poll the receipt."""
        if self._chain_id is None:
            self._chain_id = self.l1.chain_id()
        node_nonce = self.l1.get_transaction_count(self.cfg.local_account)
        # monotone local allocator: never reuse a nonce even if the node
        # hasn't seen our previous (pending) tx yet
        nonce = node_nonce if self._nonce is None else max(node_nonce, self._nonce)
        self._nonce = nonce + 1
        try:
            gas_price = self.l1.gas_price()
        except Exception:
            gas_price = 10**9
        tx = {
            "nonce": nonce,
            "gasPrice": gas_price,
            "gas": gas,
            "to": to,
            "value": 0,
            "input": "0x" + data.hex(),
        }
        signed = ethtx.sign_legacy_tx(tx, self._chain_id, self.cfg.private_key)
        raw = ethtx.encode_signed_raw(signed, self._chain_id)
        tx_hash = self.l1.send_raw_transaction(raw)
        self._wait_receipt(tx_hash)
        return tx_hash

    def _wait_receipt(self, tx_hash: str):
        """Poll eth_getTransactionReceipt until mined or timeout; raises
        on an explicit failure status."""
        deadline = time.time() + self.cfg.receipt_timeout
        while time.time() < deadline:
            receipt = self.l1.get_transaction_receipt(tx_hash)
            if receipt is not None:
                status = receipt.get("status")
                if status is not None and int(status, 16) == 0:
                    raise RuntimeError(f"tx {tx_hash} reverted")
                return receipt
            time.sleep(0.5)
        return None  # still pending: caller's watermark logic retries

    # -- bridge (signatures: interfaces/bridge.rs:13-19) ---------------------

    def bridge_asset(self, destination_network, destination_address, amount,
                     token, force_update_global_exit_root, calldata):
        data = abi.encode_call(
            "bridgeAsset(uint32,address,uint256,address,bool,bytes)",
            [("uint", 32), ("address",), ("uint", 256), ("address",), ("bool",), ("bytes",)],
            [destination_network, destination_address, amount, token,
             force_update_global_exit_root, calldata],
        )
        self._send(self.cfg.l1_contracts_addr["bridge"], data)

    def bridge_message(self, destination_network, destination_address,
                       force_update_global_exit_root, calldata):
        data = abi.encode_call(
            "bridgeMessage(uint32,address,bool,bytes)",
            [("uint", 32), ("address",), ("bool",), ("bytes",)],
            [destination_network, destination_address,
             force_update_global_exit_root, calldata],
        )
        self._send(self.cfg.l1_contracts_addr["bridge"], data)

    def claim_asset(self, smt_proof, index, mainnet_exit_root, rollup_exit_root,
                    origin_network, origin_token_address, destination_network,
                    destination_address, amount, metadata):
        data = abi.encode_call(
            "claimAsset(bytes32[32],uint32,bytes32,bytes32,uint32,address,uint32,address,uint256,bytes)",
            [("array", ("bytes32",), 32), ("uint", 32), ("bytes32",), ("bytes32",),
             ("uint", 32), ("address",), ("uint", 32), ("address",), ("uint", 256), ("bytes",)],
            [smt_proof, index, mainnet_exit_root, rollup_exit_root, origin_network,
             origin_token_address, destination_network, destination_address, amount, metadata],
        )
        self._send(self.cfg.l1_contracts_addr["bridge"], data)

    def claim_message(self, smt_proof, index, mainnet_exit_root, rollup_exit_root,
                      origin_network, origin_address, destination_network,
                      destination_address, amount, metadata):
        data = abi.encode_call(
            "claimMessage(bytes32[32],uint32,bytes32,bytes32,uint32,address,uint32,address,uint256,bytes)",
            [("array", ("bytes32",), 32), ("uint", 32), ("bytes32",), ("bytes32",),
             ("uint", 32), ("address",), ("uint", 32), ("address",), ("uint", 256), ("bytes",)],
            [smt_proof, index, mainnet_exit_root, rollup_exit_root, origin_network,
             origin_address, destination_network, destination_address, amount, metadata],
        )
        self._send(self.cfg.l1_contracts_addr["bridge"], data)

    # -- global exit root (global_exit_root.rs:13-15) ------------------------

    def update_exit_root(self, network, new_root):
        data = abi.encode_call(
            "updateExitRoot(bytes32)", [("bytes32",)], [new_root]
        )
        self._send(self.cfg.l1_contracts_addr["global_exit_root"], data)

    def get_global_exit_root(self) -> bytes:
        data = abi.selector("getLastGlobalExitRoot()")
        return self.l1.eth_call(self.cfg.l1_contracts_addr["global_exit_root"], data)

    def get_last_rollup_exit_root(self) -> bytes:
        # L2-side contract (zeth_global_exit_root.rs:10-15)
        data = abi.selector("lastRollupExitRoot()")
        return self.l2.eth_call(
            self.cfg.l2_contracts_addr.get("global_exit_root", "0x" + "00" * 20), data
        )

    # -- zkvm ----------------------------------------------------------------

    def sequence_batches(self, batches):
        data = encode_sequence_batches(batches)
        self._send(self.cfg.l1_contracts_addr["zkvm"], data)

    def verify_batches(self, pending_state_num, init_num_batch, final_new_batch,
                       new_local_exit_root, new_state_root, proof, input):
        data = encode_verify_batches(
            pending_state_num, init_num_batch, final_new_batch,
            new_local_exit_root, new_state_root, proof, input, trusted=False,
        )
        self._send(self.cfg.l1_contracts_addr["zkvm"], data)

    def verify_batches_trusted_aggregator(self, pending_state_num, init_num_batch,
                                          final_new_batch, new_local_exit_root,
                                          new_state_root, proof, input):
        data = encode_verify_batches(
            pending_state_num, init_num_batch, final_new_batch,
            new_local_exit_root, new_state_root, proof, input, trusted=True,
        )
        self._send(self.cfg.l1_contracts_addr["zkvm"], data)
