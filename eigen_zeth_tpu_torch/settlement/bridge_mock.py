"""In-repo bridge service — the HTTP process the custom settlement talks
to.

The reference requires an EXTERNAL bridge service at BRIDGE_SERVICE_ADDR
(src/config/env.rs:30-31; endpoint surface src/settlement/custom/
methods.rs) and ships none, so its custom-settlement path can only run
against a deployed bridge.  This dev implementation serves the same nine
endpoints with the same `status == 1` convention, keeps exit roots and
sequenced/verified batches in memory, and optionally Groth16-verifies
submitted proofs — which makes the 3-process devnet
(scripts/launch-devnet.sh, scripts/launch-devnet-torch.sh: node + gRPC
prover + bridge) fully hermetic.

A copy of eigen_zeth_tpu/settlement/bridge_mock.py: the same endpoints,
bodies and responses.  With a verifying key (passed to the constructor) it
checks verify-batches with the port's host `groth16.verify`.

Run standalone:  python -m eigen_zeth_tpu_torch.settlement.bridge_mock --port 8001
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional


class BridgeState:
    def __init__(self):
        self.lock = threading.Lock()
        self.mainnet_exit_root = bytes(32)
        self.rollup_exit_root = bytes(32)
        self.sequenced: List[dict] = []
        self.verified: List[dict] = []
        self.bridges: List[dict] = []
        self.claims: List[dict] = []

    def global_exit_root(self) -> bytes:
        from ..ops import keccak

        return keccak.keccak256_host(self.mainnet_exit_root + self.rollup_exit_root)


class BridgeService:
    """HTTP bridge service (ThreadingHTTPServer; port 0 = ephemeral)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 verifying_key=None):
        self.state = BridgeState()
        self.vk = verifying_key  # optional: Groth16-check verify-batches
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, body: dict):
                data = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                st = outer.state
                path = self.path.rstrip("/").lstrip("/")
                with st.lock:
                    if path == "get-global-exit-root":
                        return self._send(
                            {"status": 1,
                             "global_exit_root": st.global_exit_root().hex()}
                        )
                    if path == "get-root":
                        return self._send(
                            {"status": 1,
                             "rollup_exit_root": st.rollup_exit_root.hex()}
                        )
                self._send({"status": 0, "error": f"unknown {path}"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except Exception:
                    return self._send({"status": 0, "error": "bad json"})
                path = self.path.rstrip("/").lstrip("/")
                st = outer.state
                with st.lock:
                    if path in ("bridge-asset", "bridge-message"):
                        st.bridges.append({"kind": path, **body})
                        return self._send({"status": 1})
                    if path in ("claim-asset", "claim-message"):
                        st.claims.append({"kind": path, **body})
                        return self._send({"status": 1})
                    if path == "update-exit-root":
                        root = bytes.fromhex(body["new_root"])
                        if body.get("network", 0) == 0:
                            st.mainnet_exit_root = root
                        else:
                            st.rollup_exit_root = root
                        return self._send({"status": 1})
                    if path == "sequence-batches":
                        st.sequenced.extend(body.get("batches", []))
                        return self._send({"status": 1})
                    if path in ("verify-batches",
                                "verify-batches-trusted-aggregator"):
                        if outer.vk is not None:
                            ok = outer._check_proof(body)
                            if not ok:
                                return self._send(
                                    {"status": 0, "error": "proof rejected"}
                                )
                        st.verified.append(body)
                        return self._send({"status": 1})
                self._send({"status": 0, "error": f"unknown {path}"})

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread: Optional[threading.Thread] = None

    def _check_proof(self, body: dict) -> bool:
        """Groth16-verify the submitted proof against the configured VK —
        the role the EigenZkVM contract's verifier plays on L1."""
        try:
            from ..models import groth16

            proof = json.loads(body["proof"])
            public = [int(x) for x in json.loads(body["input"])]
            return groth16.verify(self.vk, proof, public)
        except Exception:
            return False

    def start(self) -> "BridgeService":
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        if self._thread:
            self._thread.join(5)


def main(argv=None) -> int:  # pragma: no cover - process entry
    import argparse

    p = argparse.ArgumentParser(prog="ezt-bridge-mock")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8001)
    args = p.parse_args(argv)
    svc = BridgeService(args.host, args.port).start()
    print(f"bridge service listening on {svc.url}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        svc.stop()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
