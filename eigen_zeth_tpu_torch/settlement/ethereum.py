"""The L2 JSON-RPC client — copy of `JsonRpcClient` of
eigen_zeth_tpu/settlement/ethereum.py (the ethers-providers analog), as far
as the chain executor reads the L2 through it.  The rest of settlement
(contract calldata, signing, receipts) is not ported.

Transport: stdlib urllib JSON-RPC 2.0 over HTTP.
"""

from __future__ import annotations

import json
import urllib.request


class JsonRpcClient:
    """Minimal JSON-RPC 2.0 over HTTP."""

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

    def get_block_by_number(self, number, full_txs: bool = False):
        tag = hex(number) if isinstance(number, int) else number
        return self.call("eth_getBlockByNumber", [tag, full_txs])
