"""The port's node (`python -m eigen_zeth_tpu_torch run`) against the JAX
package's node.

- The same signed transactions, sent with eth_sendRawTransaction and sealed
  at pinned timestamps, into both nodes (`run --no-prover`): the same
  JSON-RPC requests (eth_*, eigenrpc_*, engine_*, bad requests) give the
  same response bytes.  Each package's chain executor reads the other's
  node over JSON-RPC and packs the same batch.
- `init`, the stubs, `--database native` (the port's zethdb writes the
  JAX package's FileDb bytes) and `--settlement custom` (the node starts
  beside a bridge service; tests/test_torch_bridge_service.py settles
  through one).
- `run` proving in process with `--device cpu` (the test profile's small
  chunks): the proof served by eigenrpc_getBatchProof verifies under the
  JAX package's `groth16.verify` and the mock settlement records it; the
  settlement verifier is pinned to the persisted VK only for the
  in-process stark wrap, as in the JAX `cmd_run`.
- Without a CUDA device and without `--device`, `run` exits non-zero and
  names the device.

The node beside a prover over gRPC is tests/test_torch_node_grpc.py.
"""

import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from eigen_zeth_tpu import cli as j_cli
from eigen_zeth_tpu.models import groth16 as j_groth16
from eigen_zeth_tpu.protocol import prover_service as jps
from eigen_zeth_tpu.settlement import ethereum as j_eth
from eigen_zeth_tpu_torch import cli
from eigen_zeth_tpu_torch.models import stark
from eigen_zeth_tpu_torch.protocol import kv
from eigen_zeth_tpu_torch.protocol import prover_service as ps
from eigen_zeth_tpu_torch.settlement import ethereum as p_eth
from eigen_zeth_tpu_torch.utils import ethtx, secp256k1
from test_two_process import REPO, free_port

CHAIN_ID = 12345


def signed_txs(n: int, seed: int = 7):
    """n signed EIP-155 transactions from three keys (value transfers and a
    contract creation), as raw bytes."""
    keys = [0xA11CE + seed, 0xB0B + seed, 0xCAFE + seed]
    nonces = [0, 0, 0]
    out = []
    for i in range(n):
        k = i % 3
        tx = {"nonce": nonces[k], "gasPrice": (i + 1) * 10**9, "gas": 60_000 if i else 200_000,
              "to": None if i == 0 else "0x" + f"{i:040x}", "value": 10**15 * (i + 1),
              "input": "0x" + ("600a600c600039600a6000f3602a60005260206000f3" if i == 0 else "")}
        nonces[k] += 1
        out.append(ethtx.encode_signed_raw(ethtx.sign_legacy_tx(tx, CHAIN_ID, keys[k]), CHAIN_ID))
    return out, [secp256k1.priv_to_address(k).lower() for k in keys]


def run_args(*extra):
    return ["run", "--database", "memory", "--settlement", "mock", "--rpc-port", "0",
            "--auto-mine-interval", "0", "--verify-signatures", "--dev-fund", *extra]


def post(port: int, body: bytes) -> bytes:
    req = urllib.request.Request(f"http://127.0.0.1:{port}", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.read()


def call(port: int, method: str, params: list) -> bytes:
    return post(port, json.dumps({"jsonrpc": "2.0", "id": 9, "method": method,
                                  "params": params}).encode())


def drive_node(handles, raws, senders):
    """Send, seal at pinned timestamps, then ask every question; returns
    the raw response bodies."""
    port, seq = handles["server"].port, handles["sequencer"]
    out = [call(port, "eth_sendRawTransaction", ["0x" + raw.hex()]) for raw in raws[:4]]
    seq.build_block(timestamp=1_760_000_000)
    out += [call(port, "eth_sendRawTransaction", ["0x" + raw.hex()]) for raw in raws[4:]]
    out.append(call(port, "eth_sendRawTransaction", ["0x" + raws[1].hex()]))  # a replay
    out.append(call(port, "engine_forkchoiceUpdatedV3",
                    [{}, {"timestamp": hex(1_760_000_012), "suggestedFeeRecipient": "0x" + "fe" * 20,
                          "parentBeaconBlockRoot": "0x" + "ab" * 32}]))
    pid = json.loads(out[-1])["result"]["payloadId"]
    payload = json.loads(call(port, "engine_getPayloadV3", [pid]))["result"]["executionPayload"]
    out.append(json.dumps(payload).encode())
    out.append(call(port, "engine_newPayloadV3", [payload, [], payload["parentBeaconBlockRoot"]]))
    out.append(call(port, "engine_newPayloadV3", [dict(payload, stateRoot="0x" + "00" * 32)]))
    block1 = json.loads(call(port, "eth_getBlockByNumber", ["0x1", True]))["result"]
    txh = block1["transactions"][1]["hash"]
    creator = block1["transactions"][0]
    contract = json.loads(call(port, "eth_getTransactionReceipt", [creator["hash"]]))[
        "result"]["contractAddress"]
    questions = [
        ("eth_blockNumber", []), ("eth_getBlockByNumber", ["0x1", False]),
        ("eth_getBlockByNumber", ["latest", True]), ("eth_getBlockByNumber", ["safe", False]),
        ("eth_getBlockByNumber", ["0x9", False]), ("eth_getBlockByHash", [block1["hash"]]),
        ("eth_getTransactionByHash", [txh]), ("eth_getTransactionReceipt", [txh]),
        ("eth_getTransactionReceipt", ["0x" + "00" * 32]),
        ("eth_getBalance", [senders[0], "latest"]), ("eth_getCode", [contract, "latest"]),
        ("eth_getStorageAt", [contract, "0x0", "latest"]),
        ("eth_getTransactionCount", [senders[1], "latest"]), ("eth_chainId", []),
        ("eth_call", [{"to": contract, "from": senders[0]}, "latest"]),
        ("eth_estimateGas", [{"to": contract, "from": senders[0]}]),
        ("eth_gasPrice", []), ("eth_feeHistory", ["0x2", "latest", [25, 75]]),
        ("eth_syncing", []), ("net_version", []), ("web3_clientVersion", []),
        ("eth_getBlockTransactionCountByNumber", ["0x1"]),
        ("eth_getBlockTransactionCountByHash", [block1["hash"]]),
        ("eth_getTransactionByBlockNumberAndIndex", ["0x1", "0x2"]),
        ("eth_getTransactionByBlockHashAndIndex", [block1["hash"], "0x9"]),
        ("eth_getUncleCountByBlockNumber", ["0x1"]),
        ("eth_getLogs", [{"fromBlock": "earliest", "toBlock": "safe"}]),
        ("eigenrpc_customMethod", []), ("eigenrpc_getBlockByNumber", ["0x1"]),
        ("eigenrpc_getBatchProof", [1]), ("eigenrpc_traceTransaction", [txh]),
        ("engine_forkchoiceUpdatedV3", [{"headBlockHash": block1["hash"],
                                         "safeBlockHash": "0x" + "99" * 32}]),
        ("eth_blockNumber", []),
        ("engine_forkchoiceUpdatedV3", [{"headBlockHash": block1["hash"],
                                         "finalizedBlockHash": block1["hash"]}]),
        ("engine_forkchoiceUpdatedV3", [{"finalizedBlockHash": block1["parentHash"]}]),
        ("engine_getPayloadV3", ["0xdeadbeefdeadbeef"]), ("no_such_method", []),
        ("eth_sendRawTransaction", ["0x01"]),
    ]
    out += [call(port, m, p) for m, p in questions]
    out.append(post(port, b"{not json"))
    return out


def test_json_rpc_responses_equal():
    raws, senders = signed_txs(7)
    responses, batches = [], []
    readers = {cli: (j_eth.JsonRpcClient, jps.ChainExecutor),
               j_cli: (p_eth.JsonRpcClient, ps.ChainExecutor)}
    for mod in (cli, j_cli):
        handles = mod.cmd_run(mod.build_parser().parse_args(run_args("--no-prover")), wait=False)
        try:
            responses.append(drive_node(handles, raws, senders))
            # the other package's chain executor reads this node over JSON-RPC
            client, executor = readers[mod]
            url = f"http://127.0.0.1:{handles['server'].port}"
            result = executor(client(url)).execute([1], CHAIN_ID)
            batches.append((result.batch_data, result.pre_state_root, result.post_state_root))
        finally:
            handles["shutdown"]()
    assert responses[0] == responses[1]
    assert batches[0] == batches[1]
    bodies = [json.loads(r) for r in responses[0]]
    # an unknown method, a bad payload id, a bad raw tx, a regressing
    # finalized hash and bad JSON answer with errors, alike
    assert sum("error" in b for b in bodies) >= 5
    assert json.loads(responses[0][1])["result"]  # the block sealed its transactions


def test_init_stubs_and_unported_arguments(tmp_path):
    for mod, path in ((cli, tmp_path / "p.log"), (j_cli, tmp_path / "j.log")):
        assert mod.main(["init", "--database", "file", "--db-path", str(path)]) == 0
    assert (tmp_path / "p.log").read_bytes() == (tmp_path / "j.log").read_bytes()
    assert json.loads(kv.FileDb(str(tmp_path / "p.log")).get(cli.GENESIS_KEY))["chain_id"] == (
        CHAIN_ID)
    for stub in ("chain-info", "config"):
        with pytest.raises(NotImplementedError):
            cli.main([stub])
    assert cli.main(["init", "--database", "native", "--db-path", str(tmp_path / "n.log")]) == 0
    assert (tmp_path / "n.log").read_bytes() == (tmp_path / "j.log").read_bytes()
    argv = run_args("--no-prover", "--settlement", "custom")
    argv[argv.index("memory")] = "native"
    handles = cli.cmd_run(cli.build_parser().parse_args(
        argv + ["--db-path", str(tmp_path / "n.log")]), wait=False)
    try:
        assert type(handles["db"]).__name__ == "NativeDb"
        assert json.loads(handles["db"].get(cli.GENESIS_KEY))["chain_id"] == CHAIN_ID
    finally:
        handles["shutdown"]()
        handles["db"].close()


def _spawn(module, args, logfile, **env):
    return subprocess.Popen(
        [sys.executable, "-m", module] + args,
        env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", **env),
        stdout=logfile, stderr=subprocess.STDOUT, cwd=REPO,
    )


def wait_for_proof(port: int, block: int, seconds: float):
    deadline = time.time() + seconds
    while time.time() < deadline:
        got = json.loads(call(port, "eigenrpc_getBatchProof", [block]))["result"]
        if got and got.get("proof"):
            return got
        time.sleep(0.3)
    return None


def check_proof(proof: dict, port: int, block: int) -> None:
    """The JAX package's verifier accepts the proof under the test profile's
    key, and it binds the block's state root."""
    _, _, vk = jps._wrap_crs("linear", "ezt-groth16-dev")
    pub = [int(x) for x in json.loads(proof["publicInput"])]
    assert j_groth16.verify(vk, json.loads(proof["proof"]), pub)
    header = json.loads(call(port, "eth_getBlockByNumber", [hex(block), False]))["result"]
    assert proof["postStateRoot"] == header["stateRoot"]


def test_run_in_process_on_cpu(tmp_path, monkeypatch):
    """`run --device cpu` proves in process; the test profile's small chunks
    stand in for BatchProver's production defaults."""
    made = []

    def test_profile(**kw):
        assert kw["device"] == torch.device("cpu") and kw["wrap"] == "mimc"
        prover = ps.BatchProver(
            executor=kw["executor"], stark_params=stark.StarkParams(blowup=4, num_queries=2,
                                                                    terminal_size=16),
            wrap="linear", chunk_trace_rows=16, recursion=False, device=kw["device"])
        made.append(prover)
        return prover

    monkeypatch.setattr(cli, "BatchProver", test_profile)
    conf = tmp_path / "worker.toml"
    conf.write_text("[settlement_worker_config]\nproof_interval = 0.1\nverify_interval = 0.1\n"
                    "rollup_interval = 0.1\nwatcher_interval = 0.1\n")
    args = cli.build_parser().parse_args(run_args("--device", "cpu", "--final-wrap", "mimc",
                                                  "--worker-conf", str(conf)))
    handles = cli.cmd_run(args, wait=False)
    try:
        port = handles["server"].port
        raws, _ = signed_txs(3, seed=5)
        for raw in raws:
            call(port, "eth_sendRawTransaction", ["0x" + raw.hex()])
        handles["sequencer"].build_block(timestamp=1_760_000_000)
        proof = wait_for_proof(port, 1, 120)
        assert proof is not None, "no proof served within 120 s"
        check_proof(proof, port, 1)
        deadline = time.time() + 30
        settlement = handles["operator"].settlement
        while not settlement.verified and time.time() < deadline:
            time.sleep(0.1)
        assert [v.new_state_root.hex() for v in settlement.verified] == [
            proof["postStateRoot"][2:]]
        assert made and made[0].device == torch.device("cpu")
    finally:
        handles["shutdown"]()


def test_settlement_pinned_to_the_persisted_vk_only_in_process(tmp_path, monkeypatch):
    pinned = object()
    monkeypatch.setattr(ps.BatchProver, "pinned_vk", lambda self, addr: pinned)
    cases = [(run_args("--device", "cpu", "--crs-dir", str(tmp_path)), pinned),
             (run_args("--device", "cpu", "--final-wrap", "mimc"), None),
             (run_args("--prover-addr", "127.0.0.1:1"), None)]
    for argv, want in cases:
        handles = cli.cmd_run(cli.build_parser().parse_args(argv), wait=False)
        try:
            assert handles["operator"].settlement.vk is want
            prover = handles["operator"].prover
            if "--crs-dir" in argv:
                assert prover.crs_dir == str(tmp_path) and prover.wrap == "stark"
        finally:
            handles["shutdown"]()


def test_run_without_a_cuda_device_names_it_and_fails():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "eigen_zeth_tpu_torch", "run", "--rpc-port",
                           str(free_port())], env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "run: device 'cuda'" in proc.stderr
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert "listening" not in proc.stderr + proc.stdout
