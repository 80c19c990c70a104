"""The port's node beside a prover over gRPC.

- The node (`python -m eigen_zeth_tpu_torch run --prover-addr`) and a
  prover as two OS processes: the port's prover (`--device cpu`) and the JAX
  package's (`prover --stark-profile test`).  Signed transactions are
  sequenced, proved over gRPC, settled and served by
  eigenrpc_getBatchProof; the JAX package's `groth16.verify` accepts the
  proof under the test profile's verifying key, it binds the block's state
  root, and the block reaches Finalized.  The node runs where CUDA is
  hidden: with `--prover-addr` it needs no card.
- Forked host workers (`groth16._over_ranges`) finish within their timeout
  under a live node whose prover is a gRPC server in the same process.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from test_torch_node_cli import _spawn, call, check_proof, signed_txs, wait_for_proof
from test_two_process import REPO, free_port, wait_port

FORK_TIMEOUT_S = 120


@pytest.mark.parametrize("prover_pkg", ["eigen_zeth_tpu_torch", "eigen_zeth_tpu"])
def test_port_node_gets_a_verified_proof_over_grpc(tmp_path, prover_pkg):
    rpc_port, prover_port = free_port(), free_port()
    worker_conf = tmp_path / "worker.toml"
    worker_conf.write_text("[settlement_worker_config]\nproof_interval = 0.2\n"
                           "verify_interval = 0.2\nrollup_interval = 0.2\nwatcher_interval = 0.2\n")
    prover_log, node_log = open(tmp_path / "prover.log", "w"), open(tmp_path / "node.log", "w")
    extra = ["--device", "cpu"] if prover_pkg == "eigen_zeth_tpu_torch" else []
    prover_p = _spawn(prover_pkg, ["prover", "--port", str(prover_port), "--l2-addr",
                                   f"http://127.0.0.1:{rpc_port}", "--stark-profile", "test",
                                   "--no-jit", *extra], prover_log, OMP_NUM_THREADS="1")
    # the node needs no card: it is started where CUDA is hidden, without --device
    node_p = _spawn("eigen_zeth_tpu_torch",
                    ["run", "--database", "memory", "--settlement", "mock", "--rpc-port",
                     str(rpc_port), "--auto-mine-interval", "0.3", "--worker-conf",
                     str(worker_conf), "--verify-signatures", "--dev-fund", "--prover-addr",
                     f"http://127.0.0.1:{prover_port}"], node_log, CUDA_VISIBLE_DEVICES="")
    try:
        assert wait_port(prover_port, 60), "prover process did not bind"
        assert wait_port(rpc_port, 60), "node process did not bind"
        raws, _ = signed_txs(2, seed=11)
        for raw in raws:
            assert "result" in json.loads(call(rpc_port, "eth_sendRawTransaction",
                                               ["0x" + raw.hex()]))
        proof = wait_for_proof(rpc_port, 1, 120)
        assert proof is not None, "no proof served within 120 s"
        check_proof(proof, rpc_port, 1)
        deadline = time.time() + 30
        while time.time() < deadline:  # the mock settlement verified it: Finalized
            status = json.loads(call(rpc_port, "eigenrpc_getBlockByNumber", ["0x1"]))["result"]
            if status["status"] == "Finalized":
                break
            time.sleep(0.3)
        assert status["status"] == "Finalized"
    finally:
        for p in (node_p, prover_p):
            p.send_signal(signal.SIGTERM)
        for p in (node_p, prover_p):
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        prover_log.close()
        node_log.close()


FORK_UNDER_NODE = textwrap.dedent("""
    import json, threading, time, urllib.request
    from eigen_zeth_tpu_torch import cli
    from eigen_zeth_tpu_torch.models import groth16

    groth16.HOST_WORKERS = 4  # fork even on a host of few cores
    N = groth16.PARALLEL_MIN


    def span(shared, lo, hi):
        return shared * (hi - lo) + sum(range(lo, hi))


    def fork_pass():
        parts = groth16._over_ranges(span, N, 3)
        assert len(parts) == 4, parts
        return sum(parts)


    node = cli.cmd_run(cli.build_parser().parse_args(
        ["run", "--database", "memory", "--rpc-port", "0", "--auto-mine-interval", "0.05",
         "--dev-fund", "--prover-addr", "127.0.0.1:PROVER_PORT"]), wait=False)
    server = cli.cmd_prover(cli.build_parser().parse_args(
        ["prover", "--port", "PROVER_PORT", "--stark-profile", "test", "--device", "cpu",
         "--l2-addr", f"http://127.0.0.1:{node['server'].port}"]), wait=False)
    try:
        node["sequencer"].send_raw_transaction(
            {"nonce": "0x0", "gasPrice": "0x2", "gas": "0x5208", "from": "0x" + "11" * 20,
             "to": "0x" + "22" * 20, "value": "0x5", "input": "0x"})
        want = 3 * N + N * (N - 1) // 2
        results = []
        worker = threading.Thread(target=lambda: results.append(fork_pass()))
        worker.start()
        results.append(fork_pass())  # on the main thread, beside the node's threads
        worker.join()
        assert results == [want, want], results
        deadline = time.time() + 90
        while time.time() < deadline and not node["db"].get_proof(1):
            time.sleep(0.2)
        assert node["db"].get_proof(1) is not None, "no proof while forking"
        assert fork_pass() == want  # after a proof went over the wire
    finally:
        node["shutdown"]()
        server.stop(0)
    print("forked passes done")
""")


def test_forks_finish_under_a_live_node():
    script = FORK_UNDER_NODE.replace("PROVER_PORT", str(free_port()))
    proc = subprocess.run([sys.executable, "-c", script],
                          env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"), cwd=REPO,
                          capture_output=True, text=True, timeout=FORK_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "forked passes done" in proc.stdout
    # gRPC's fork handlers stay off (they restart its threads in each child)
    assert "fork_posix" not in proc.stderr and "Check failed" not in proc.stderr, proc.stderr
