"""The port's sequencer against the JAX package's, on the same transactions.

The same signed transactions (EIP-155, keys from a numpy seed; a contract
that logs, value transfers, a forged signature, a nonce gap, a bridge call
under the tx filter) go into both packages' `Sequencer`s, and blocks are
sealed at pinned timestamps.  Every block dict (hash, state root,
transactions root, receipts root, bloom, gas used), receipt, log query,
transaction lookup, fee history, call, gas estimate and forkchoice result,
a reorg and the reference's own forkchoice faults included, must be equal.
"""

import dataclasses

import numpy as np
import pytest

from eigen_zeth_tpu.sequencer import chain as j_chain
from eigen_zeth_tpu_torch.sequencer import chain as p_chain
from eigen_zeth_tpu_torch.ops import keccak
from eigen_zeth_tpu_torch.utils import ethtx, rlp, secp256k1

CHAIN_ID = 12345
BRIDGE = "0x0000000000000000000000000000000000000b01"
SELECTOR = "0x647c576c"
# runtime: LOG1(topic = CALLVALUE) of 32 bytes of memory holding CALLDATALOAD(0),
# SSTORE(NUMBER, CALLDATALOAD(0)), RETURN 32 bytes
LOGGER = bytes([0x60, 0x00, 0x35, 0x60, 0x00, 0x52, 0x34, 0x60, 0x20, 0x60, 0x00, 0xA1,
                0x60, 0x00, 0x35, 0x43, 0x55, 0x60, 0x20, 0x60, 0x00, 0xF3])
LOGGER_INIT = bytes([0x60, len(LOGGER), 0x60, 0x0C, 0x60, 0x00, 0x39,
                     0x60, len(LOGGER), 0x60, 0x00, 0xF3]) + LOGGER


def norm(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, norm(vars(x)))
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


def outcome(fn, *args, **kwargs):
    try:
        return ("ok", norm(fn(*args, **kwargs)))
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        return ("raised", type(e).__name__, str(e))


def signed_batches(seed: int):
    """Three blocks' worth of signed transactions from four keys."""
    rng = np.random.default_rng(seed)
    keys = [int.from_bytes(rng.bytes(32), "big") % secp256k1.N for _ in range(4)]
    senders = [secp256k1.priv_to_address(k).lower() for k in keys]
    nonces = [0] * 4

    def tx(i, to, value=0, data=b"", gas=100_000, price=None, nonce=None):
        n = nonces[i] if nonce is None else nonce
        if nonce is None:
            nonces[i] += 1
        body = {"nonce": hex(n), "gasPrice": hex(price or int(rng.integers(1, 50)) * 10**9),
                "gas": hex(gas), "to": to, "value": hex(value), "input": "0x" + data.hex()}
        out = ethtx.sign_legacy_tx(body, CHAIN_ID, keys[i])
        out["from"] = senders[i]
        return out

    logger = "0x" + keccak.keccak256_host(
        rlp.encode([bytes.fromhex(senders[0][2:]), 0]))[12:].hex()
    first = [tx(0, None, data=LOGGER_INIT, gas=500_000),
             tx(1, "0x" + rng.bytes(20).hex(), value=10**18),
             tx(2, BRIDGE, data=bytes.fromhex(SELECTOR[2:]) + bytes(32)),
             tx(3, BRIDGE, data=bytes.fromhex(SELECTOR[2:]) + bytes(31) + b"\x01")]
    forged = dict(tx(1, "0x" + rng.bytes(20).hex(), value=5), value=hex(6))
    gap = tx(3, "0x" + rng.bytes(20).hex(), value=1, nonce=7)
    second = [tx(0, logger, value=3, data=rng.bytes(32)),
              tx(1, logger, value=4, data=rng.bytes(32)), forged, gap,
              tx(2, "0x" + rng.bytes(20).hex(), value=10**17)]
    third = [tx(0, logger, value=9, data=rng.bytes(32)), tx(2, logger, data=rng.bytes(32))]
    return [first, second, third], logger, senders


BATCHES, LOGGER_ADDR, SENDERS = signed_batches(2026)


def run_chain(m):
    cfg = m.TxFilterConfig(bridge_contract_address=BRIDGE, bridge_asset_selector=SELECTOR)
    seq = m.Sequencer(tx_filter=cfg, chain_id=CHAIN_ID, verify_signatures=True,
                      coinbase="0x" + "cb" * 20, auto_fund=True)
    seq.ledger.ctx.basefee = 10**9  # a live fee market: the base fee moves block by block
    out = {"genesis": seq.get_block_by_number(0), "blocks": [], "receipts": [], "pool": []}
    hashes = []
    for k, batch in enumerate(BATCHES):
        for tx in batch:
            hashes.append(seq.send_raw_transaction(tx))
        blk = seq.build_block(timestamp=1_760_000_000 + 12 * k,
                              withdrawals=[{"index": hex(k), "validatorIndex": "0x7",
                                            "address": SENDERS[3], "amount": hex(10 + k)}])
        out["blocks"].append(blk)
        out["pool"].append(len(seq.pool))
    out["receipts"] = [seq.get_transaction_receipt(h) for h in hashes]
    out["lookups"] = [seq.get_transaction_by_hash(h) for h in hashes]
    out["traces"] = [seq.get_transaction_trace(h) for h in hashes]
    out["logs"] = [seq.get_logs(), seq.get_logs(2, 3, address=LOGGER_ADDR),
                   seq.get_logs(0, None, topics=[hex(3).replace("0x", "0x" + "0" * 63)]),
                   seq.get_logs(topics=[None]), seq.get_logs(5, 9)]
    out["tags"] = [seq.get_block_by_number(t) for t in ("latest", "earliest", "safe",
                                                         "finalized", "pending", "0x2", 9)]
    out["fees"] = [seq.fee_history(3, "latest", [10, 90]), seq.fee_history(2, "0x2")]
    call = {"from": SENDERS[1], "to": LOGGER_ADDR, "input": "0x" + "ab" * 32}
    out["call"] = [outcome(seq.call_view, call), outcome(seq.estimate_gas, call)]
    out["state"] = {a: (acc.nonce, acc.balance, acc.code.hex(), sorted(acc.storage.items()))
                    for a, acc in sorted(seq.ledger.state.accounts.items())}
    return seq, norm(out)


def test_blocks_receipts_logs_equal():
    _, got = run_chain(p_chain)
    _, want = run_chain(j_chain)
    assert got == want
    # one of the two bridge-asset calls is deferred to the next block; the
    # forged signature is evicted, so its sender's next nonce waits in the
    # pool beside the transaction sent with a nonce gap
    assert [len(b["transactions"]) for b in got["blocks"]] == [3, 3, 2]
    assert got["pool"] == [1, 2, 2]
    assert all(r is None or r["status"] == "0x1" for r in got["receipts"])
    assert got["logs"][0]


def forkchoice_steps(m):
    seq, _ = run_chain(m)
    blocks = [seq.get_block_by_number(n) for n in range(4)]
    h = [b["hash"] for b in blocks]
    unknown = "0x" + "99" * 32
    steps = [
        ("safe+finalized", dict(safe_hash=h[1], finalized_hash=h[1])),
        ("unknown head", dict(head_hash=unknown)),
        ("reorg to 2", dict(head_hash=h[2])),
        ("finalized regresses", dict(finalized_hash=h[0])),  # raises (chain.py:407)
        ("reorg below finalized", dict(head_hash=h[0])),
        ("safe below finalized", dict(safe_hash=h[0])),
        # a valid head with an unknown safe hash: the head moves, then SYNCING (chain.py:420)
        ("reorg to 1, unknown safe", dict(head_hash=h[1], safe_hash=unknown)),
        ("unknown finalized", dict(finalized_hash=unknown)),
        ("zero hashes", dict(head_hash="0x" + "00" * 32, safe_hash="0x" + "00" * 32)),
    ]
    out = []
    for name, kw in steps:
        out.append((name, outcome(seq.set_forkchoice, **kw), seq.block_number(), len(seq.pool),
                    seq.safe_hash, seq.finalized_hash, seq.ledger.state_root().hex()))
    # the orphaned transactions were re-injected; seal them again
    blk = seq.build_block(timestamp=1_760_000_100)
    out.append((blk, seq.get_block_by_number("safe"), seq.get_block_by_number("finalized"),
                seq.get_logs()))
    return norm(out)


def test_forkchoice_and_reorg_equal():
    got = forkchoice_steps(p_chain)
    assert got == forkchoice_steps(j_chain)
    by_name = {step[0]: step[1] for step in got[:-1]}
    assert by_name["reorg to 2"] == ["ok", "VALID"]
    assert by_name["finalized regresses"][0] == "raised"
    assert by_name["reorg to 1, unknown safe"] == ["ok", "SYNCING"]


@pytest.mark.parametrize("interval", [0.05])
def test_auto_mine_seals_pending_transactions(interval):
    """start_auto_mine on both packages: the pool drains into sealed blocks
    whose transactions equal (the clock stamps the blocks, so their roots
    and hashes may differ)."""
    import threading
    import time

    sealed = []
    for m in (p_chain, j_chain):
        seq = m.Sequencer(chain_id=CHAIN_ID, verify_signatures=True)
        for tx in BATCHES[0][:2]:
            seq.send_raw_transaction(tx)
        stop = threading.Event()
        thread = seq.start_auto_mine(stop, interval)
        deadline = time.time() + 20
        while len(seq.pool) and time.time() < deadline:
            time.sleep(interval)
        stop.set()
        thread.join(5)
        sealed.append([b["transactions"] for b in (seq.get_block_by_number(n)
                                 for n in range(1, seq.block_number() + 1))])
    assert sealed[0] == sealed[1] and sealed[0]
