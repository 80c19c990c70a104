"""The port's `prover` command as a deployment runs it.

- The twin of tests/test_two_process.py: an unmodified JAX node (`python -m
  eigen_zeth_tpu run --prover-addr`) and the port's prover (`python -m
  eigen_zeth_tpu_torch prover --stark-profile test --device cpu`) as two OS
  processes over gRPC.  A transaction is sequenced, proved by the port over
  the wire and served by `eigenrpc_getBatchProof`; the proof verifies under
  the JAX package's verifying key of the test profile's linear wrap, and
  binds the node's state root.
- Without a CUDA device and without `--device`, the command exits non-zero
  and names the device: it never proves on the CPU unless asked.
- `groth16._over_ranges` forks host workers for a large circuit; under the
  server it does so on a gRPC handler thread, beside gRPC's own threads.  A
  trivial pass at PARALLEL_MIN constraints must finish within its timeout
  there and on the main thread while the server serves, and gRPC's fork
  handlers (which restart its threads in each child, where they aborted
  workers on an H100 host) must not run.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

from eigen_zeth_tpu.models import groth16 as jgroth16
from eigen_zeth_tpu.protocol import prover_service as jps
from eigen_zeth_tpu.protocol.grpc_shim import RemoteBatchProver
from test_two_process import REPO, TX, free_port, rpc, wait_port

FORK_TIMEOUT_S = 120


def _spawn(module, args, logfile, **env):
    return subprocess.Popen(
        [sys.executable, "-m", module] + args,
        env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", **env),
        stdout=logfile, stderr=subprocess.STDOUT, cwd=REPO,
    )


def test_jax_node_gets_a_verified_proof_from_the_port_prover(tmp_path):
    rpc_port, prover_port = free_port(), free_port()
    worker_conf = tmp_path / "worker.toml"
    worker_conf.write_text(
        "[settlement_worker_config]\n"
        "proof_interval = 0.2\nverify_interval = 0.2\n"
        "rollup_interval = 0.2\nwatcher_interval = 0.2\n"
    )
    prover_log = open(tmp_path / "prover.log", "w")
    node_log = open(tmp_path / "node.log", "w")
    prover_p = _spawn(
        "eigen_zeth_tpu_torch",
        ["prover", "--port", str(prover_port), "--l2-addr", f"http://127.0.0.1:{rpc_port}",
         "--stark-profile", "test", "--no-jit", "--device", "cpu"],
        prover_log, OMP_NUM_THREADS="1",
    )
    node_p = _spawn(
        "eigen_zeth_tpu",
        ["run", "--database", "memory", "--settlement", "mock",
         "--rpc-port", str(rpc_port), "--auto-mine-interval", "0.3",
         "--worker-conf", str(worker_conf), "--dev-fund",
         "--prover-addr", f"http://127.0.0.1:{prover_port}"],
        node_log,
    )
    try:
        assert wait_port(prover_port, 60), "prover process did not bind"
        assert wait_port(rpc_port, 60), "node process did not bind"

        out = rpc(rpc_port, "eth_sendTransaction", [TX])
        assert "result" in out, out

        proof = None
        deadline = time.time() + 120
        while time.time() < deadline:
            got = rpc(rpc_port, "eigenrpc_getBatchProof", [1])["result"]
            if got and got.get("proof"):
                proof = got
                break
            time.sleep(0.5)
        assert proof is not None, "no proof served within 120s"
        final = json.loads(proof["proof"])
        assert final["protocol"] == "groth16"
        _, _, vk = jps._wrap_crs("linear", "ezt-groth16-dev")
        pub = [int(x) for x in json.loads(proof["publicInput"])]
        assert jgroth16.verify(vk, final, pub)
        block = rpc(rpc_port, "eth_getBlockByNumber", ["0x1", False])["result"]
        assert proof["postStateRoot"] == block["stateRoot"]

        remote = RemoteBatchProver(f"127.0.0.1:{prover_port}")
        try:
            ps = remote.get_status().prover_status
            assert ps.prover_name == "ezt-tpu-prover"
            assert ps.number_of_cores >= 1
            assert ps.total_memory > 0
            assert ps.last_computed_request_id != ""  # it proved something
            assert ps.version_server.startswith("eigen-zeth-tpu-torch")
        finally:
            remote.close()
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


def test_without_a_cuda_device_the_command_names_it_and_fails():
    proc = subprocess.run(
        [sys.executable, "-m", "eigen_zeth_tpu_torch", "prover", "--port", "0",
         "--stark-profile", "test"],
        env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""), cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "'cuda'" in proc.stderr and "torch.cuda.is_available() is False" in proc.stderr
    assert "listening" not in proc.stderr + proc.stdout


FORK_UNDER_SERVER = textwrap.dedent("""
    import json, threading
    from eigen_zeth_tpu_torch.models import groth16
    from eigen_zeth_tpu_torch.protocol import grpc_shim
    from eigen_zeth_tpu_torch.protocol.messages import GenAggregatedProofResult, ProofResultCode

    groth16.HOST_WORKERS = 4  # fork even on a host of few cores
    N = groth16.PARALLEL_MIN


    def span(shared, lo, hi):
        return shared * (hi - lo) + sum(range(lo, hi))


    def fork_pass():
        parts = groth16._over_ranges(span, N, 3)
        assert len(parts) == 4, parts
        return sum(parts)


    class ForkingProver:
        def gen_aggregated_proof(self, batch_id, p1, p2):
            handler = threading.current_thread() is not threading.main_thread()
            return GenAggregatedProofResult(batch_id, ProofResultCode.COMPLETED_OK,
                                            json.dumps([fork_pass(), handler]))


    server = grpc_shim.ProverServiceServer(ForkingProver()).start()
    client = grpc_shim.RemoteBatchProver(f"127.0.0.1:{server.port}")
    try:
        want = 3 * N + N * (N - 1) // 2
        assert fork_pass() == want  # on the main thread, the server serving
        for _ in range(2):  # on a handler thread
            res = client.gen_aggregated_proof("b", "", "")
            assert res.result_code == ProofResultCode.COMPLETED_OK, res.error_message
            assert json.loads(res.result_string) == [want, True]
        assert client.get_status().status == 3  # STATUS_IDLE: the server still answers
    finally:
        client.close()
        server.stop(0)
    print("forked passes done")
""")


def test_over_ranges_forks_while_the_server_serves():
    proc = subprocess.run([sys.executable, "-c", FORK_UNDER_SERVER],
                          env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
                          capture_output=True, text=True, timeout=FORK_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "forked passes done" in proc.stdout
    # gRPC's fork handlers stay off: they restart gRPC's threads in each
    # child, which aborted workers on an H100 host
    assert "fork_posix" not in proc.stderr and "Check failed" not in proc.stderr, proc.stderr


def test_only_the_server_imports_grpc():
    """The state machine, the store, the pipeline, the prover and the CLI
    module import without grpc; the server and the `prover` command bring it."""
    code = (
        "import sys\n"
        "from eigen_zeth_tpu_torch import cli\n"
        "from eigen_zeth_tpu_torch.parallel import pipeline\n"
        "from eigen_zeth_tpu_torch.protocol import kv, prover_service, state_machine\n"
        "assert 'grpc' not in sys.modules\n"
        "from eigen_zeth_tpu_torch.protocol import grpc_shim\n"
        "assert 'grpc' in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=REPO),
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
