"""eigenrpc JSON-RPC server + mock L2 chain.

Server mirror of the reference's jsonrpsee `eigenrpc` namespace extension
(src/custom_reth/eigen.rs:17-28):
  * eigenrpc_customMethod       — returns block 0 info (eigen.rs:44-47)
  * eigenrpc_getBlockByNumber   — block joined with its rollup Status
                                  from the KV store (eigen.rs:49-67)
  * eigenrpc_getBatchProof      — BatchProofInfo from BATCH_PROOF_{n}
                                  (eigen.rs:76-97): proof, public_input,
                                  0x-hex pre/post state roots
  * eigenrpc_traceTransaction   — unimplemented stub, like the reference
                                  (eigen.rs:70-74)

MockChain implements the minimal eth_* surface the pipeline consumes
(eth_blockNumber, eth_getBlockByNumber) so the node runs hermetically —
the role the reference fills with a live reth devnet.

A copy of eigen_zeth_tpu/protocol/rpc.py: the same requests give the
same responses as the JAX node's.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..ops import keccak
from .kv import Database, PREFIX_BATCH_PROOF, ProofResult


class MockChain:
    """In-memory L2: blocks with optional transactions."""

    def __init__(self):
        self._lock = threading.Lock()
        self._blocks = [
            {
                "number": "0x0",
                "transactions": [],
                "timestamp": "0x0",
                "stateRoot": "0x" + keccak.keccak256_host(b"mock-genesis").hex(),
            }
        ]

    def add_block(self, transactions: Optional[list] = None, timestamp: int = 0):
        with self._lock:
            n = len(self._blocks)
            # keccak-chained state root over the parent root + tx content,
            # so tampering a stored tx breaks the chain binding
            parent_root = bytes.fromhex(self._blocks[-1]["stateRoot"][2:])
            content = json.dumps(transactions or [], sort_keys=True).encode()
            root = keccak.keccak256_host(parent_root + content)
            self._blocks.append(
                {
                    "number": hex(n),
                    "transactions": transactions or [],
                    "timestamp": hex(timestamp),
                    "stateRoot": "0x" + root.hex(),
                }
            )
            return n

    def block_number(self) -> int:
        with self._lock:
            return len(self._blocks) - 1

    def get_block_by_number(self, number, full_txs: bool = False):
        n = int(number, 16) if isinstance(number, str) else int(number)
        with self._lock:
            if 0 <= n < len(self._blocks):
                return dict(self._blocks[n])
        return None


def batch_proof_info(db: Database, block_number: int) -> Optional[dict]:
    """BatchProofInfo shape (reference: eigen.rs:86-93, 108-117)."""
    pr = db.get_proof(block_number)
    if pr is None:
        return None
    return {
        "blockNumber": pr.block_number,
        "proof": pr.proof,
        "publicInput": pr.public_input,
        "preStateRoot": "0x" + pr.pre_state_root.hex(),
        "postStateRoot": "0x" + pr.post_state_root.hex(),
    }


class EigenRpcServer:
    """HTTP JSON-RPC endpoint serving eigenrpc_* (+ proxied eth_*)."""

    def __init__(self, db: Database, chain, host: str = "127.0.0.1", port: int = 0):
        self.db = db
        self.chain = chain
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                # prometheus scrape surface (reference analog: reth's
                # --metrics socket, src/commands/reth.rs:48-49)
                if self.path.rstrip("/") in ("/metrics", ""):
                    from ..utils.profiling import METRICS

                    data = METRICS.prometheus_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                self.send_response(404)
                self.end_headers()

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(length))
                    result = outer.dispatch(req.get("method", ""), req.get("params", []))
                    body = {"jsonrpc": "2.0", "id": req.get("id"), "result": result}
                except Exception as e:
                    body = {
                        "jsonrpc": "2.0",
                        "id": None,
                        "error": {"code": -32000, "message": str(e)},
                    }
                data = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._payloads: dict = {}  # payloadId -> built execution payload

    def dispatch(self, method: str, params: list):
        if method == "eigenrpc_customMethod":
            return {"block": self.chain.get_block_by_number(0), "status": None}
        if method == "eigenrpc_getBlockByNumber":
            n = int(params[0], 16) if isinstance(params[0], str) else int(params[0])
            block = self.chain.get_block_by_number(n)
            status = self.db.get_status(n)
            return {"block": block, "status": status.value if status else None}
        if method == "eigenrpc_getBatchProof":
            n = int(params[0], 16) if isinstance(params[0], str) else int(params[0])
            return batch_proof_info(self.db, n)
        if method == "eigenrpc_traceTransaction":
            # the reference stubs this (eigen.rs:70-74 Err("Unable to trace"));
            # here it serves a geth-callTracer call tree recorded at
            # execution time by the EVM (sequencer/evm.py)
            if hasattr(self.chain, "get_transaction_trace"):
                trace = self.chain.get_transaction_trace(params[0])
                if trace is not None:
                    return trace
            raise ValueError(f"no trace for transaction {params[0]!r}")
        if method == "eth_blockNumber":
            return hex(self.chain.block_number())
        if method == "eth_getBlockByNumber":
            return self.chain.get_block_by_number(params[0], bool(params[1:]))
        if method == "eth_getBlockByHash":
            if hasattr(self.chain, "get_block_by_hash"):
                return self.chain.get_block_by_hash(params[0])
            return None
        if method == "eth_getTransactionByHash":
            if hasattr(self.chain, "get_transaction_by_hash"):
                return self.chain.get_transaction_by_hash(params[0])
            return None
        if method == "eth_sendTransaction":
            if hasattr(self.chain, "send_raw_transaction"):
                return self.chain.send_raw_transaction(params[0])
            raise ValueError("chain does not accept transactions")
        if method == "eth_sendRawTransaction":
            # wire-format ingestion: RLP/typed-envelope decode + sender
            # recovery (the reth rpc surface the reference exposes)
            from ..utils import ethtx

            if not hasattr(self.chain, "send_raw_transaction"):
                raise ValueError("chain does not accept transactions")
            raw = bytes.fromhex(str(params[0])[2:])
            tx = ethtx.decode_raw_tx(raw)
            return self.chain.send_raw_transaction(tx)
        if method == "eth_getTransactionReceipt":
            if hasattr(self.chain, "get_transaction_receipt"):
                return self.chain.get_transaction_receipt(params[0])
            return None
        if method == "eth_getBalance":
            if hasattr(self.chain, "ledger"):
                return hex(
                    self.chain.ledger.state.get(params[0].lower()).balance
                )
            return "0x0"
        if method == "eth_getCode":
            if hasattr(self.chain, "ledger"):
                return "0x" + self.chain.ledger.state.get(params[0].lower()).code.hex()
            return "0x"
        if method == "eth_getStorageAt":
            if hasattr(self.chain, "ledger"):
                slot = int(params[1], 16) if isinstance(params[1], str) else int(params[1])
                v = self.chain.ledger.state.get(params[0].lower()).storage.get(slot, 0)
                return "0x%064x" % v
            return "0x" + "00" * 32
        if method == "eth_getTransactionCount":
            if hasattr(self.chain, "ledger"):
                return hex(self.chain.ledger.state.get(params[0].lower()).nonce)
            return "0x0"
        if method == "eth_chainId":
            if hasattr(self.chain, "chain_id"):
                return hex(self.chain.chain_id)
            return "0x1"
        if method == "eth_call":
            if hasattr(self.chain, "call_view"):
                return self.chain.call_view(params[0])
            raise ValueError("chain does not execute calls")
        if method == "eth_estimateGas":
            if hasattr(self.chain, "estimate_gas"):
                return hex(self.chain.estimate_gas(params[0]))
            raise ValueError("chain does not execute calls")
        if method == "eth_gasPrice":
            base = 0
            if hasattr(self.chain, "ledger"):
                base = self.chain.ledger.ctx.basefee
            return hex(max(base, 1))
        if method == "eth_feeHistory":
            if hasattr(self.chain, "fee_history"):
                count = params[0]
                count = int(count, 16) if isinstance(count, str) else int(count)
                return self.chain.fee_history(
                    count,
                    params[1] if len(params) > 1 else "latest",
                    params[2] if len(params) > 2 else None,
                )
            raise ValueError("chain has no fee history")
        if method == "eth_syncing":
            return False
        if method == "net_version":
            return str(self.chain.chain_id if hasattr(self.chain, "chain_id") else 1)
        if method == "web3_clientVersion":
            return "eigen-zeth-tpu/0.2"
        if method in ("eth_getBlockTransactionCountByNumber",
                      "eth_getBlockTransactionCountByHash"):
            if method.endswith("ByHash") and hasattr(self.chain, "get_block_by_hash"):
                b = self.chain.get_block_by_hash(params[0])
            else:
                b = self.chain.get_block_by_number(params[0])
            return hex(len(b["transactions"])) if b else None
        if method in ("eth_getTransactionByBlockNumberAndIndex",
                      "eth_getTransactionByBlockHashAndIndex"):
            if method.endswith("HashAndIndex") and hasattr(self.chain, "get_block_by_hash"):
                b = self.chain.get_block_by_hash(params[0])
            else:
                b = self.chain.get_block_by_number(params[0])
            if not b:
                return None
            i = int(params[1], 16) if isinstance(params[1], str) else int(params[1])
            if not (0 <= i < len(b["transactions"])):
                return None
            tx = dict(b["transactions"][i])
            tx.update(blockHash=b["hash"], blockNumber=b["number"],
                      transactionIndex=hex(i))
            return tx
        if method in ("eth_getUncleCountByBlockNumber",
                      "eth_getUncleCountByBlockHash"):
            return "0x0"  # PoS L2: no uncles
        if method.startswith("engine_"):
            return self._engine(method, params)
        if method == "eth_getLogs":
            if not hasattr(self.chain, "get_logs"):
                return []
            f = params[0] if params else {}

            def _bn(v, default):
                if v is None:
                    return default
                if isinstance(v, str):
                    if v in ("latest", "pending", "safe", "finalized"):
                        return self.chain.block_number()
                    if v == "earliest":
                        return 0
                    return int(v, 16)
                return int(v)

            return self.chain.get_logs(
                from_block=_bn(f.get("fromBlock"), 0),
                to_block=_bn(f.get("toBlock"), None),
                address=f.get("address"),
                topics=f.get("topics"),
            )
        raise ValueError(f"unknown method {method!r}")

    # -- engine API analog ---------------------------------------------------
    # The reference embeds reth, whose payload service speaks the Engine
    # API (CustomEngineTypes / CustomPayloadAttributes,
    # custom_reth/mod.rs:84-205,302-339).  This in-process sequencer IS
    # the payload builder, so the engine methods drive it directly:
    # forkchoiceUpdated+attributes builds a payload, getPayload returns
    # it, newPayload re-checks a payload against the canonical chain.

    def _engine(self, method: str, params: list):
        if not hasattr(self.chain, "build_block"):
            raise ValueError("chain has no payload builder")
        if method.startswith("engine_forkchoiceUpdated"):
            state = params[0] or {}
            attrs = params[1] if len(params) > 1 else None
            want = (state.get("headBlockHash") or "").lower()
            if hasattr(self.chain, "set_forkchoice"):
                # full forkchoice: head may REORG to a canonical ancestor
                # (above finalized); safe/finalized markers advance
                status = self.chain.set_forkchoice(
                    head_hash=want or None,
                    safe_hash=state.get("safeBlockHash"),
                    finalized_hash=state.get("finalizedBlockHash"),
                )
                if status != "VALID":
                    return {
                        "payloadStatus": {"status": status,
                                          "latestValidHash": None,
                                          "validationError": None},
                        "payloadId": None,
                    }
                head = self.chain.get_block_by_number(self.chain.block_number())
            else:
                head = self.chain.get_block_by_number(self.chain.block_number())
                if want and want != head["hash"].lower():
                    return {
                        "payloadStatus": {"status": "SYNCING",
                                          "latestValidHash": None,
                                          "validationError": None},
                        "payloadId": None,
                    }
            payload_id = None
            if attrs:
                ts = attrs.get("timestamp")
                block = self.chain.build_block(
                    timestamp=int(ts, 16) if isinstance(ts, str) else ts,
                    parent_beacon_block_root=attrs.get("parentBeaconBlockRoot"),
                    fee_recipient=attrs.get("suggestedFeeRecipient"),
                    withdrawals=attrs.get("withdrawals"),
                )
                payload_id = "0x" + block["hash"][2:18]
                self._payloads[payload_id] = block
            return {
                "payloadStatus": {"status": "VALID",
                                  "latestValidHash": head["hash"],
                                  "validationError": None},
                "payloadId": payload_id,
            }
        if method.startswith("engine_getPayload"):
            block = self._payloads.get(params[0])
            if block is None:
                raise ValueError(f"unknown payloadId {params[0]!r}")
            return {
                "executionPayload": block,
                "blockValue": "0x0",
                "blobsBundle": {"commitments": [], "proofs": [], "blobs": []},
                "shouldOverrideBuilder": False,
            }
        if method.startswith("engine_newPayload"):
            payload = params[0] or {}
            n = int(payload.get("number", "0x0"), 16)
            ours = self.chain.get_block_by_number(n)
            known = ours is not None and all(
                payload.get(k) == ours.get(k)
                for k in ("hash", "parentHash", "stateRoot",
                          "transactionsRoot", "receiptsRoot")
            )
            return {
                "status": "VALID" if known else "INVALID",
                "latestValidHash": ours["hash"] if known else None,
                "validationError": None if known else "unknown or divergent payload",
            }
        raise ValueError(f"unknown engine method {method!r}")

    def start(self):
        self._thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.server.shutdown()
        if self._thread:
            self._thread.join(5)


class MetricsServer:
    """Standalone prometheus socket (the reference's `--metrics <socket>`
    reth flag, src/commands/reth.rs:45-49) — /metrics is also served on
    the main RPC port; this mirrors reth's separate-listener shape."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        from ..utils.profiling import METRICS

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                data = METRICS.prometheus_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.server.shutdown()
        if self._thread:
            self._thread.join(5)
