"""Consensus-layer analog: a slot ticker that drives the Engine API.

Plays lighthouse's role in the reference's PoS topology
(the reference's scripts/launch-pos-eigen-zeth-node.sh:54-61: zeth as EL
+ lighthouse bn/vc as CL): every slot it runs the CL side of the payload
handshake against the EL's JSON-RPC endpoint —

    engine_forkchoiceUpdatedV3(head, attributes)  -> payloadId
    engine_getPayloadV3(payloadId)                -> executionPayload
    engine_newPayloadV3(payload)                  -> VALID
    engine_forkchoiceUpdatedV3(new head)          -> head advanced

so the devnet produces blocks through the REAL engine flow instead of
the --auto-mine shortcut.  A copy of eigen_zeth_tpu/sequencer/cl_driver.py;
the port's eigenrpc serves the engine methods.  Run as its own process:

    python -m eigen_zeth_tpu_torch.sequencer.cl_driver --el http://127.0.0.1:8546 \
        --slot 2 --fee-recipient 0x...
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import threading
import time
import urllib.request

log = logging.getLogger("ezt.cl")


class EngineClient:
    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url
        self.timeout = timeout
        self._id = 0

    def call(self, method: str, params: list):
        self._id += 1
        body = json.dumps(
            {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
        ).encode()
        req = urllib.request.Request(
            self.url, data=body, headers={"Content-Type": "application/json"}
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            out = json.loads(resp.read())
        if out.get("error"):
            raise RuntimeError(f"{method}: {out['error']}")
        return out["result"]


def tick(client: EngineClient, fee_recipient: str,
         finality_depth: int = 2) -> dict | None:
    """One slot: full CL->EL payload handshake; returns the new block
    header dict (or None when the EL reports no head advance).

    safe tracks the head; finalized trails it by `finality_depth` blocks
    — the slot-ticker analog of the beacon chain's justified/finalized
    distinction (mainnet: head > safe(justified) > finalized, ~2 epochs
    behind; the reference's lighthouse CL maintains the same three
    markers, launch-pos-eigen-zeth-node.sh:54-61)."""
    head_n = int(client.call("eth_blockNumber", []), 16)
    head = client.call("eth_getBlockByNumber", [hex(head_n), False])
    fin = client.call(
        "eth_getBlockByNumber", [hex(max(0, head_n - finality_depth)), False]
    )
    fcu_state = {
        "headBlockHash": head["hash"],
        "safeBlockHash": head["hash"],
        "finalizedBlockHash": fin["hash"],
    }
    attrs = {
        "timestamp": hex(int(time.time())),
        "prevRandao": "0x" + "00" * 32,
        "suggestedFeeRecipient": fee_recipient,
        "withdrawals": [],
        "parentBeaconBlockRoot": head["hash"],
    }
    r = client.call("engine_forkchoiceUpdatedV3", [fcu_state, attrs])
    status = r["payloadStatus"]["status"]
    if status != "VALID" or not r.get("payloadId"):
        log.warning("forkchoiceUpdated: %s", status)
        return None
    payload = client.call("engine_getPayloadV3", [r["payloadId"]])
    block = payload["executionPayload"]
    v = client.call("engine_newPayloadV3", [block])
    if v["status"] != "VALID":
        raise RuntimeError(f"newPayload rejected: {v}")
    # advance the fork choice to the built block; finality recomputed
    # against the NEW head so the marker keeps its fixed trailing gap
    fin2 = client.call(
        "eth_getBlockByNumber",
        [hex(max(0, head_n + 1 - finality_depth)), False],
    )
    client.call(
        "engine_forkchoiceUpdatedV3",
        [{
            "headBlockHash": block["hash"],
            "safeBlockHash": block["hash"],
            "finalizedBlockHash": fin2["hash"],
        }],
    )
    return block


def run(el_url: str, slot_seconds: float, fee_recipient: str,
        stop: threading.Event | None = None, max_slots: int | None = None,
        finality_depth: int = 2) -> int:
    """Slot loop; returns the number of blocks produced."""
    client = EngineClient(el_url)
    stop = stop or threading.Event()
    produced = 0
    while not stop.is_set():
        try:
            block = tick(client, fee_recipient, finality_depth=finality_depth)
            if block is not None:
                produced += 1
                log.info(
                    "slot: built block %s (%d txs) %s",
                    int(block["number"], 16),
                    len(block.get("transactions") or []),
                    block["hash"][:18],
                )
        except Exception as e:  # EL restarting / not yet up
            log.warning("slot failed: %s", e)
        if max_slots is not None and produced >= max_slots:
            break
        stop.wait(slot_seconds)
    return produced


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ezt-cl-driver")
    ap.add_argument("--el", default="http://127.0.0.1:8546",
                    help="EL JSON-RPC endpoint (engine_* + eth_*)")
    ap.add_argument("--slot", type=float, default=12.0,
                    help="slot time in seconds (testdata/layer2/pos: 12 s)")
    ap.add_argument("--fee-recipient", default="0x" + "00" * 20)
    ap.add_argument("--max-slots", type=int, default=None)
    ap.add_argument("--finality-depth", type=int, default=2,
                    help="blocks the finalized marker trails the head")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    run(args.el, args.slot, args.fee_recipient, stop=stop,
        max_slots=args.max_slots, finality_depth=args.finality_depth)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
