"""The port's CL driver (`sequencer/cl_driver.py`) against the JAX package's,
over the engine API of both nodes.

- The port's `cl_driver.run` drives the port's node and the JAX node (each
  an eigenrpc server over its own sequencer, with the same signed
  transactions in the mempool) at pinned slot timestamps: every block,
  header, fee recipient and transaction list served by eth_getBlockByNumber
  is equal, and equal to what the JAX package's own driver builds on the
  JAX node.  The safe and finalized markers trail the head alike.
- `python -m eigen_zeth_tpu_torch.sequencer.cl_driver --max-slots 1` seals
  a block on the port's node through the engine flow.
Tolerance: none, JSON equality.
"""

import json
import os
import subprocess
import sys
import types

import pytest

from eigen_zeth_tpu.protocol import kv as j_kv
from eigen_zeth_tpu.protocol import rpc as j_rpc
from eigen_zeth_tpu.sequencer import chain as j_chain
from eigen_zeth_tpu.sequencer import cl_driver as j_cl
from eigen_zeth_tpu_torch.protocol import kv, rpc
from eigen_zeth_tpu_torch.sequencer import chain, cl_driver
from test_torch_node_cli import CHAIN_ID, signed_txs
from test_two_process import REPO

FEE = "0x" + "ab" * 20
T0 = 1_760_000_000


def pinned_clock(module, monkeypatch):
    """The CL driver's `time.time()` steps 12 s a call from T0."""
    ticks = iter(range(T0, T0 + 12 * 1000, 12))
    monkeypatch.setattr(module, "time", types.SimpleNamespace(time=lambda: next(ticks)))


def node(seq_mod, kv_mod, rpc_mod, raws):
    seq = seq_mod.Sequencer(chain_id=CHAIN_ID, verify_signatures=True, auto_fund=True)
    server = rpc_mod.EigenRpcServer(kv_mod.MemDb(), seq).start()
    for raw in raws:
        server.dispatch("eth_sendRawTransaction", ["0x" + raw.hex()])
    return seq, server


def blocks(server, n):
    return [json.dumps(server.dispatch("eth_getBlockByNumber", [hex(i), True]), sort_keys=True)
            for i in range(n + 1)] + [
        json.dumps(server.dispatch("eth_getBlockByNumber", [tag, False]), sort_keys=True)
        for tag in ("safe", "finalized", "latest")]


@pytest.mark.parametrize("slots", [1, 3])
def test_cl_driver_blocks_equal(monkeypatch, slots):
    raws, _ = signed_txs(3, seed=3)
    runs = []
    for driver, pkg in ((cl_driver, (chain, kv, rpc)), (cl_driver, (j_chain, j_kv, j_rpc)),
                        (j_cl, (j_chain, j_kv, j_rpc))):
        pinned_clock(driver, monkeypatch)
        seq, server = node(*pkg, raws)
        try:
            produced = driver.run(f"http://127.0.0.1:{server.port}", slot_seconds=0.0,
                                  fee_recipient=FEE, max_slots=slots, finality_depth=2)
            assert produced == slots and seq.block_number() == slots
            runs.append(blocks(server, slots))
        finally:
            server.stop()
    assert runs[0] == runs[1] == runs[2]
    first = json.loads(runs[0][1])
    assert len(first["transactions"]) == 3 and first["miner"] == FEE
    assert first["timestamp"] == hex(T0)
    safe, fin = (json.loads(r) for r in runs[0][-3:-1])
    assert int(safe["number"], 16) == slots and int(fin["number"], 16) == max(0, slots - 2)


def test_cl_driver_module_entry_point():
    seq = chain.Sequencer()
    seq.send_raw_transaction({"from": "0x" + "11" * 20, "to": "0x" + "22" * 20, "value": "0x5"})
    server = rpc.EigenRpcServer(kv.MemDb(), seq).start()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "eigen_zeth_tpu_torch.sequencer.cl_driver", "--el",
             f"http://127.0.0.1:{server.port}", "--slot", "0.05", "--max-slots", "1",
             "--fee-recipient", FEE], env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert "slot: built block 1 (1 txs)" in proc.stderr
        assert seq.block_number() == 1 and seq.get_block_by_number(1)["miner"] == FEE
    finally:
        server.stop()
