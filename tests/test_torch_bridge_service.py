"""The port's custom settlement (`CustomSettlement`, the bridge REST client)
and bridge service (`BridgeService`) against the JAX package's.

- The same raw HTTP requests to both bridges, every endpoint and a few bad
  ones, give the same response bytes.
- The port's client against the JAX bridge and the JAX client against the
  port's bridge make the same calls: both bridges end in the same state and
  the clients read back the same roots.
- With a tiny linear wrap's verifying key, the port's bridge accepts the
  port's Groth16 proof on verify-batches and refuses a forged pi_c and a
  wrong public input (status 0, nothing recorded), as the JAX bridge does.
- The tiny node (`run --settlement custom --database native --device cpu`,
  the test profile's small chunks) settles its block through a live port
  bridge that checks the proof under the prover's key.
- `python -m eigen_zeth_tpu_torch.settlement.bridge_mock` serves.
Tolerance: none, byte equality.
"""

import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from eigen_zeth_tpu.models import groth16 as j_groth16
from eigen_zeth_tpu.settlement import bridge_mock as j_bridge
from eigen_zeth_tpu.settlement import custom as j_custom
from eigen_zeth_tpu.settlement.interface import BatchData as JBatchData
from eigen_zeth_tpu_torch import cli
from eigen_zeth_tpu_torch.models import stark
from eigen_zeth_tpu_torch.protocol import kv
from eigen_zeth_tpu_torch.protocol import prover_service as ps
from eigen_zeth_tpu_torch.settlement import bridge_mock, custom
from eigen_zeth_tpu_torch.settlement.interface import BatchData
from eigen_zeth_tpu_torch.utils import config
from test_torch_node_cli import run_args, signed_txs, wait_for_proof
from test_torch_settlement import linear_wrap_proof
from test_two_process import REPO, free_port

RAW = [
    ("GET", "get-global-exit-root", None),
    ("GET", "get-root", None),
    ("POST", "update-exit-root", {"network": 1, "new_root": "11" * 32}),
    ("POST", "update-exit-root", {"network": 0, "new_root": "22" * 32}),
    ("GET", "get-global-exit-root/", None),
    ("GET", "/get-root", None),
    ("POST", "bridge-asset", {"destination_network": 1, "amount": "5", "calldata": "0102"}),
    ("POST", "bridge-message", {"destination_network": 1, "calldata": ""}),
    ("POST", "claim-asset", {"index": 7, "smt_proof": ["00" * 32]}),
    ("POST", "claim-message", {"index": 8, "metadata": "ab"}),
    ("POST", "sequence-batches", {"batches": [{"transactions": "aabb", "timestamp": 42}]}),
    ("POST", "verify-batches", {"init_num_batch": 0, "proof": "{}", "input": "[]"}),
    ("POST", "verify-batches-trusted-aggregator", {"final_new_batch": 3}),
    ("POST", "no-such-endpoint", {}),
    ("GET", "no-such-endpoint", None),
    ("POST", "sequence-batches", b"{not json"),
]


def raw_request(url: str, method: str, path: str, body) -> bytes:
    data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(f"{url}/{path.lstrip('/')}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.read()


@pytest.fixture()
def bridges():
    svcs = [bridge_mock.BridgeService().start(), j_bridge.BridgeService().start()]
    yield svcs
    for svc in svcs:
        svc.stop()


def state(svc) -> str:
    st = svc.state
    return json.dumps([st.mainnet_exit_root.hex(), st.rollup_exit_root.hex(), st.sequenced,
                       st.verified, st.bridges, st.claims, st.global_exit_root().hex()])


def test_raw_responses_equal(bridges):
    port, jax = bridges
    for method, path, body in RAW:
        assert raw_request(port.url, method, path, body) == raw_request(jax.url, method, path,
                                                                          body), path
    assert state(port) == state(jax)


def drive_client(settlement, batch_cls):
    """Every method of the Settlement surface; returns what it read back."""
    got = [settlement.get_last_rollup_exit_root(), settlement.get_global_exit_root()]
    settlement.update_exit_root(1, bytes(range(32)))
    settlement.update_exit_root(0, bytes(range(32, 64)))
    settlement.bridge_asset(1, "0x" + "aa" * 20, 1000, "0x" + "00" * 20, True, b"\x01\x02")
    settlement.bridge_message(1, "0x" + "bb" * 20, False, b"")
    settlement.claim_asset([b"\x00" * 32] * 2, 7, bytes(32), bytes(32), 0, "0x" + "00" * 20, 1,
                           "0x" + "cc" * 20, 5, b"")
    settlement.claim_message([b"\x01" * 32] * 2, 8, bytes(32), bytes(32), 0, "0x" + "dd" * 20, 1,
                             "0x" + "ee" * 20, 5, b"meta")
    settlement.sequence_batches([batch_cls(transactions=b"\xaa\xbb", global_exit_root=bytes(32),
                                           timestamp=42)])
    settlement.verify_batches(0, 0, 1, bytes(32), b"\x05" * 32, '{"pi_a": {}}', "[]")
    settlement.verify_batches_trusted_aggregator(0, 1, 2, b"\x06" * 32, b"\x07" * 32, "{}", "[]")
    return got + [settlement.get_last_rollup_exit_root(), settlement.get_global_exit_root()]


def test_clients_across_packages(bridges):
    port, jax = bridges
    got_port = drive_client(custom.CustomSettlement(jax.url), BatchData)
    got_jax = drive_client(j_custom.CustomSettlement(port.url), JBatchData)
    assert got_port == got_jax
    assert state(port) == state(jax)
    assert got_port[2] == bytes(range(32))


def test_verify_batches_under_a_vk():
    proof_json, input_json, vk = linear_wrap_proof()
    proof = json.loads(proof_json)
    forged = json.dumps(dict(proof, pi_c=dict(proof["pi_a"])))
    wrong_input = json.dumps([str(int(json.loads(input_json)[0]) + 1)])
    outcomes = []
    for svc, client in ((bridge_mock.BridgeService(verifying_key=vk), custom.CustomSettlement),
                        (j_bridge.BridgeService(verifying_key=j_groth16.VerifyingKey(**vars(vk))),
                         j_custom.CustomSettlement)):
        svc.start()
        try:
            s = client(svc.url)
            s.verify_batches(0, 0, 1, bytes(32), bytes(32), proof_json, input_json)
            refused = []
            for p, i in ((forged, input_json), (proof_json, wrong_input)):
                with pytest.raises(RuntimeError, match="proof rejected") as err:
                    s.verify_batches(0, 1, 2, bytes(32), bytes(32), p, i)
                refused.append(str(err.value))
            outcomes.append((len(svc.state.verified), refused))
        finally:
            svc.stop()
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == 1  # the refused ones are not recorded


def test_tiny_node_settles_through_a_live_bridge(tmp_path, monkeypatch):
    vk = ps._wrap_crs("linear", "ezt-groth16-dev", torch.device("cpu"))[2]
    bridge = bridge_mock.BridgeService(verifying_key=vk).start()

    def test_profile(**kw):
        return ps.BatchProver(
            executor=kw["executor"], stark_params=stark.StarkParams(blowup=4, num_queries=2,
                                                                    terminal_size=16),
            wrap="linear", chunk_trace_rows=16, recursion=False, device=kw["device"])

    monkeypatch.setattr(cli, "BatchProver", test_profile)
    monkeypatch.setenv("BRIDGE_SERVICE_ADDR", bridge.url)
    config.global_env.cache_clear()
    conf = tmp_path / "worker.toml"
    conf.write_text("[settlement_worker_config]\nproof_interval = 0.1\nverify_interval = 0.1\n"
                    "rollup_interval = 0.1\nwatcher_interval = 0.1\n")
    argv = run_args("--device", "cpu", "--final-wrap", "mimc", "--worker-conf", str(conf),
                    "--db-path", str(tmp_path / "n.log"))
    argv[argv.index("memory")], argv[argv.index("mock")] = "native", "custom"
    handles = cli.cmd_run(cli.build_parser().parse_args(argv), wait=False)
    try:
        assert type(handles["operator"].settlement).__name__ == "CustomSettlement"
        port = handles["server"].port
        raws, _ = signed_txs(2, seed=11)
        for raw in raws:
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}", headers={"Content-Type": "application/json"},
                data=json.dumps({"jsonrpc": "2.0", "id": 1, "method": "eth_sendRawTransaction",
                                 "params": ["0x" + raw.hex()]}).encode()), timeout=10).read()
        handles["sequencer"].build_block(timestamp=1_760_000_000)
        proof = wait_for_proof(port, 1, 120)
        assert proof is not None, "no proof served within 120 s"
        deadline = time.time() + 30
        while not bridge.state.verified and time.time() < deadline:
            time.sleep(0.1)
        assert len(bridge.state.verified) == 1
        verified = bridge.state.verified[0]
        assert verified["new_state_root"] == proof["postStateRoot"][2:]
        assert (verified["proof"], verified["input"]) == (proof["proof"], proof["publicInput"])
        assert len(bridge.state.sequenced) == 1
    finally:
        handles["shutdown"]()
        bridge.stop()
        config.global_env.cache_clear()
    db = kv.FileDb(str(tmp_path / "n.log"))  # the native log, read by the python engine
    assert db.get_status(1) is not None
    db.close()


def test_bridge_module_entry_point():
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "eigen_zeth_tpu_torch.settlement.bridge_mock", "--port", str(port)],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == f"bridge service listening on http://127.0.0.1:{port}"
        s = custom.CustomSettlement(f"http://127.0.0.1:{port}")
        s.update_exit_root(1, b"\x09" * 32)
        assert s.get_last_rollup_exit_root() == b"\x09" * 32
    finally:
        proc.terminate()
        proc.wait(30)
