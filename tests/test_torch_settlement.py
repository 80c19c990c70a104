"""The port's settlement layer against the JAX package's.

- ABI and `proof_codec` bytes on inputs drawn from a numpy seed, and
  `parse_proof` / `parse_public_input` on the reference's proof vectors.
- `EthereumSettlement` (with a local wallet and with node-managed keys)
  against a stand-in L1 on loopback: every JSON-RPC request it sends, the
  calldata and the signed raw transactions included, must be equal.
- `MockSettlement` accepts a Groth16 proof of the linear wrap under its
  verifying key and rejects a forged pi_c, as the JAX package's does.
- The settlement workers: the same blocks through both packages' `Settler`
  and `L2Watcher` give the same database writes and settlement calls.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from eigen_zeth_tpu.models import groth16 as j_groth16
from eigen_zeth_tpu.protocol import kv as j_kv
from eigen_zeth_tpu.protocol import vectors
from eigen_zeth_tpu.settlement import abi as j_abi
from eigen_zeth_tpu.settlement import ethereum as j_eth
from eigen_zeth_tpu.settlement import interface as j_iface
from eigen_zeth_tpu.settlement import mock as j_mock
from eigen_zeth_tpu.settlement import proof_codec as j_codec
from eigen_zeth_tpu.settlement import worker as j_worker
from eigen_zeth_tpu_torch.models import groth16
from eigen_zeth_tpu_torch.protocol import kv
from eigen_zeth_tpu_torch.protocol import prover_service as ps
from eigen_zeth_tpu_torch.settlement import abi, proof_codec
from eigen_zeth_tpu_torch.settlement import ethereum as p_eth
from eigen_zeth_tpu_torch.settlement import interface as p_iface
from eigen_zeth_tpu_torch.settlement import mock as p_mock
from eigen_zeth_tpu_torch.settlement import worker as p_worker

R = groth16.R
PROOF_JSON = json.dumps(vectors.reference_proof())
INPUT_JSON = json.dumps(vectors.reference_public_input())


def outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        return ("raised", type(e).__name__, str(e))


def random_value(rng, t):
    kind = t[0]
    if kind == "uint":
        return int.from_bytes(rng.bytes(t[1] // 8), "big")
    if kind == "bool":
        return bool(rng.integers(0, 2))
    if kind == "address":
        return "0x" + rng.bytes(20).hex()
    if kind == "bytes32":
        return rng.bytes(32)
    if kind == "bytes":
        return rng.bytes(int(rng.integers(0, 100)))
    if kind == "tuple":
        return tuple(random_value(rng, s) for s in t[1])
    n = t[2] if t[2] is not None else int(rng.integers(0, 4))
    return [random_value(rng, t[1]) for _ in range(n)]


def random_type(rng, depth: int = 0):
    leaves = [("uint", 8), ("uint", 64), ("uint", 256), ("bool",), ("address",), ("bytes32",),
              ("bytes",)]
    k = int(rng.integers(0, 10 if depth < 2 else 7))
    if k < 7:
        return leaves[k]
    if k == 7:
        return ("tuple", [random_type(rng, depth + 1) for _ in range(int(rng.integers(1, 4)))])
    return ("array", random_type(rng, depth + 1), None if k == 8 else int(rng.integers(1, 3)))


@pytest.mark.parametrize("seed", range(3))
def test_abi_encoding_equal(seed):
    rng = np.random.default_rng(seed)
    for sig in ("transfer(address,uint256)", "verifyBatches(uint64)", "lastRollupExitRoot()"):
        assert abi.selector(sig) == j_abi.selector(sig)
    assert abi.selector("transfer(address,uint256)").hex() == "a9059cbb"
    for _ in range(40):
        types = [random_type(rng) for _ in range(int(rng.integers(1, 5)))]
        values = [random_value(rng, t) for t in types]
        assert abi.encode(types, values) == j_abi.encode(types, values)
        assert abi.encode_call("f(x)", types, values) == j_abi.encode_call("f(x)", types, values)


def test_proof_codec_equal():
    parsed = proof_codec.parse_proof(PROOF_JSON)
    assert parsed == j_codec.parse_proof(PROOF_JSON)
    ref = vectors.reference_proof()
    assert parsed[0] == (int(ref["pi_a"]["x"]), int(ref["pi_a"]["y"]))
    assert parsed[1][0] == [int(x) for x in ref["pi_b"]["x"]]  # file order, no swap
    pub = proof_codec.parse_public_input(INPUT_JSON)
    assert pub == j_codec.parse_public_input(INPUT_JSON) == [int(vectors.reference_public_input()[0])]
    for trusted in (False, True):
        args = (3, 7, 8, b"\x11" * 32, b"\x22" * 32, PROOF_JSON, INPUT_JSON, trusted)
        assert proof_codec.encode_verify_batches(*args) == j_codec.encode_verify_batches(*args)
    rng = np.random.default_rng(4)
    batches = [p_iface.BatchData(transactions=rng.bytes(int(rng.integers(0, 300))),
                                 global_exit_root=rng.bytes(32), timestamp=1_760_000_000 + i)
               for i in range(3)]
    j_batches = [j_iface.BatchData(b.transactions, b.global_exit_root, b.timestamp)
                 for b in batches]
    assert proof_codec.encode_sequence_batches(batches) == j_codec.encode_sequence_batches(
        j_batches)
    for bad in ("{}", "not json", json.dumps({"pi_a": {"x": "1"}})):
        assert outcome(proof_codec.parse_proof, bad) == outcome(j_codec.parse_proof, bad)
    assert (proof_codec.GAS_LIMIT, proof_codec.VERIFY_BATCHES_SIG, proof_codec.PROOF_TYPE) == (
        j_codec.GAS_LIMIT, j_codec.VERIFY_BATCHES_SIG, j_codec.PROOF_TYPE)


class StandInL1:
    """A stock node's JSON-RPC as far as settlement uses it; records every
    request (method and params)."""

    def __init__(self):
        self.requests = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                method, params = body["method"], body.get("params", [])
                outer.requests.append((method, params))
                result = {
                    "eth_chainId": hex(777),
                    "eth_getTransactionCount": hex(5),
                    "eth_gasPrice": hex(7 * 10**9),
                    "eth_sendRawTransaction": "0x" + "ab" * 32,
                    "eth_sendTransaction": "0x" + "cd" * 32,
                    "eth_getTransactionReceipt": {"status": "0x1"},
                    "eth_call": "0x" + "ee" * 32,
                }[method]
                data = json.dumps({"jsonrpc": "2.0", "id": body["id"], "result": result}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def drive_settlement(eth, iface, private_key):
    node = StandInL1()
    try:
        cfg = eth.EthereumSettlementConfig(
            provider_url=node.url, local_account="0x" + "0a" * 20,
            l1_contracts_addr={"bridge": "0x" + "01" * 20, "global_exit_root": "0x" + "02" * 20,
                               "zkvm": "0x" + "03" * 20},
            l2_contracts_addr={"global_exit_root": "0x" + "04" * 20},
            private_key=private_key, receipt_timeout=5.0)
        st = eth.EthereumSettlement(cfg)
        smt = [bytes([i]) * 32 for i in range(32)]
        st.bridge_asset(1, "0x" + "05" * 20, 10**18, "0x" + "06" * 20, True, b"\x01\x02")
        st.bridge_message(2, "0x" + "07" * 20, False, b"hello")
        st.claim_asset(smt, 3, b"\x08" * 32, b"\x09" * 32, 0, "0x" + "0b" * 20, 1,
                       "0x" + "0c" * 20, 55, b"")
        st.claim_message(smt, 4, b"\x0d" * 32, b"\x0e" * 32, 0, "0x" + "0f" * 20, 1,
                         "0x" + "10" * 20, 66, b"meta")
        st.update_exit_root(0, b"\x11" * 32)
        views = [st.get_global_exit_root(), st.get_last_rollup_exit_root()]
        st.sequence_batches([iface.BatchData(b"\xaa" * 70, b"\x12" * 32, 1_760_000_000)])
        st.verify_batches(0, 1, 2, b"\x13" * 32, b"\x14" * 32, PROOF_JSON, INPUT_JSON)
        st.verify_batches_trusted_aggregator(0, 2, 3, b"\x15" * 32, b"\x16" * 32, PROOF_JSON,
                                             INPUT_JSON)
        return node.requests, views
    finally:
        node.stop()


@pytest.mark.parametrize("private_key", [None, 0xC0FFEE], ids=["node-keys", "local-wallet"])
def test_ethereum_settlement_requests_equal(private_key):
    got = drive_settlement(p_eth, p_iface, private_key)
    assert got == drive_settlement(j_eth, j_iface, private_key)
    sent = [m for m, _ in got[0]]
    want = "eth_sendRawTransaction" if private_key else "eth_sendTransaction"
    assert sent.count(want) == 8
    assert got[1] == [b"\xee" * 32] * 2


def test_ethereum_settlement_config_equal(tmp_path):
    conf = tmp_path / "settlement.toml"
    conf.write_text(
        '[ethereum_settlement_config]\nprovider_url = "http://127.0.0.1:1"\n'
        '[ethereum_settlement_config.local_wallet]\nprivate_key = "0x01"\n'
        '[ethereum_settlement_config.l1_contracts_addr]\n'
        'bridge = "0x0000000000000000000000000000000000000001"\n'
        'global_exit_root = "0x0000000000000000000000000000000000000002"\n'
        'zkvm = "0x0000000000000000000000000000000000000003"\n')
    got = p_eth.EthereumSettlementConfig.from_conf_path(str(conf))
    assert vars(got) == vars(j_eth.EthereumSettlementConfig.from_conf_path(str(conf)))
    assert got.local_account.lower() == "0x7e5f4552091a69125d5dfcb7b8c2659029395bdf"
    custom = p_iface.init_settlement_provider("custom", bridge_service_addr="http://127.0.0.1:1/")
    assert (type(custom).__name__, custom.url) == ("CustomSettlement", "http://127.0.0.1:1")
    assert type(p_iface.init_settlement_provider("mock")).__name__ == "MockSettlement"


def linear_wrap_proof():
    """A Groth16 proof of the linear wrap made by the port on the CPU, its
    public input and verifying key."""
    r1cs, pk, vk = ps._wrap_crs("linear", "ezt-groth16-dev", torch.device("cpu"))
    h = [0x1234, 0x5678, 0x9ABC, 0xDEF0]
    x1 = (h[0] + (h[1] << 64) + (h[2] << 128) + (h[3] << 192)) % R
    proof = groth16.prove(pk, r1cs, [1, x1, *h, h[0] * h[1] % R], device=torch.device("cpu"))
    return json.dumps(proof), json.dumps([str(x1)]), vk


def settle(mock, vk, proof_json, input_json):
    st = mock.MockSettlement(verifying_key=vk)
    res = outcome(st.verify_batches, 0, 0, 1, b"\x01" * 32, b"\x02" * 32, proof_json, input_json)
    st.update_exit_root(1, b"\x03" * 32)
    st.sequence_batches(["batch"])
    st.bridge_asset(1, "0x" + "05" * 20, 7, "0x" + "06" * 20, True, b"")
    return res, [vars(v) for v in st.verified], st.get_global_exit_root(), \
        st.get_last_rollup_exit_root(), st.bridge_events, st.sequenced


def test_mock_settlement_accepts_and_rejects_alike():
    proof_json, input_json, vk = linear_wrap_proof()
    j_vk = j_groth16.VerifyingKey(**vars(vk))
    ok = settle(p_mock, vk, proof_json, input_json)
    assert ok == settle(j_mock, j_vk, proof_json, input_json)
    assert ok[0] == ("ok", None) and len(ok[1]) == 1
    proof = json.loads(proof_json)
    forged = json.dumps(dict(proof, pi_c=dict(proof["pi_a"])))
    bad = settle(p_mock, vk, forged, input_json)
    assert bad == settle(j_mock, j_vk, forged, input_json)
    assert bad[0] == ("raised", "ValueError", "groth16 verification failed") and not bad[1]
    # without a verifying key the mock records the batch unverified, as the JAX one does
    assert settle(p_mock, None, forged, input_json) == settle(j_mock, None, forged, input_json)


class Recorder:
    """A Settlement stand-in that records every call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, [[vars(b) for b in a] if isinstance(a, list) else a
                                      for a in args]))
            return b"\x77" * 32
        return call


class StubPipeline:
    def __init__(self, kvmod):
        self.kv = kvmod

    def execute(self, n):
        return self.kv.ProofResult(block_number=n, proof=f"proof-{n}", public_input=f"[{n}]",
                                   pre_state_root=bytes([n]) * 32,
                                   post_state_root=bytes([n + 1]) * 32)


class StubChain:
    def __init__(self):
        tx = {"nonce": "0x1", "gasPrice": "0x2", "gas": "0x5208", "to": "0x" + "22" * 20,
              "value": "0x3", "input": "0x", "chainId": "0x3039", "v": "0x1b", "r": "0x2",
              "s": "0x3"}
        self.blocks = [{"number": hex(n), "timestamp": hex(1000 + n),
                        "transactions": [tx] * (n % 3)} for n in range(6)]

    def block_number(self):
        return len(self.blocks) - 1

    def get_block_by_number(self, n, full=False):
        return self.blocks[n] if n < len(self.blocks) else None


def drive_workers(worker, kvmod):
    db, settlement, chain = kvmod.MemDb(), Recorder(), StubChain()
    settler = worker.Settler(db=db, pipeline=StubPipeline(kvmod), settlement=settlement,
                             chain=chain, chain_id=12345)
    watcher = worker.L2Watcher(db, chain)
    for _ in range(12):
        watcher.tick()
        settler.rollup_tick()
        settler.proof_tick()
        settler.verify_tick()
    return dict(sorted(db._d.items())), settlement.calls


def test_settlement_workers_equal(tmp_path):
    got = drive_workers(p_worker, kv)
    assert got == drive_workers(j_worker, j_kv)
    assert got[0][b"BLOCK_STATUS_5"] == b"Finalized"
    conf = tmp_path / "worker.toml"
    conf.write_text("[settlement_worker_config]\nproof_interval = 0.2\nwatcher_interval = 3\n")
    assert vars(p_worker.WorkerConfig.from_conf_path(str(conf))) == vars(
        j_worker.WorkerConfig.from_conf_path(str(conf)))
