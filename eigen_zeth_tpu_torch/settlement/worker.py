"""Pipeline workers — L2 watcher + proof / verify / rollup loops.

Mirror of the reference's worker set:
  * L2Watcher     (src/batch_proposer/mod.rs): polls the L2 head, marks
                  new blocks Sequenced, persists the finality watermark
  * proof_worker  (src/settlement/worker.rs:99-222): drives the proving
                  state machine for the next submitted-but-unproven
                  block, stores BATCH_PROOF_{n}, bumps watermarks
  * verify_worker (worker.rs:224-313): settles each proven batch via
                  Settlement.verify_batches, marks Finalized
  * rollup        (worker.rs:315-474): packs new L2 blocks into BatchData
                  (EIP-155 legacy-tx RLP + decimal v,r,s bytes, matching
                  worker.rs:425-449/477-554) and sequences them; empty
                  blocks take the fast path that finalizes immediately
                  with a placeholder proof in the reference's strict
                  watermark order (worker.rs:382-420)

Concurrency model: the reference's tokio tasks + broadcast stop channels
(src/operator.rs:62-116) become daemon threads + threading.Event; the
DB-mediated watermark coordination is identical.

A copy of eigen_zeth_tpu/settlement/worker.py, over the port's
`ProverPipeline` and `METRICS`.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass

from ..protocol import kv
from ..protocol.kv import (
    KEY_LAST_PROVEN_BLOCK_NUMBER,
    KEY_LAST_SEQUENCE_FINALITY_BLOCK_NUMBER,
    KEY_LAST_SUBMITTED_BLOCK_NUMBER,
    KEY_LAST_VERIFIED_BATCH_NUMBER,
    KEY_LAST_VERIFIED_BLOCK_NUMBER,
    KEY_NEXT_BATCH,
    Database,
    ProofResult,
    Status,
)
from ..protocol.state_machine import ProverPipeline
from ..utils import rlp
from .interface import BatchData, Settlement

from ..utils.profiling import METRICS

log = logging.getLogger("ezt.worker")


@dataclass
class WorkerConfig:
    """Tick intervals (reference: configs/settlement.toml
    settlement_worker_config — 1s each; src/settlement/worker.rs:30-43)."""

    proof_interval: float = 1.0
    verify_interval: float = 1.0
    rollup_interval: float = 1.0
    watcher_interval: float = 30.0  # batch_proposer/mod.rs:10

    @classmethod
    def from_conf_path(cls, path: str) -> "WorkerConfig":
        import tomllib

        with open(path, "rb") as f:
            conf = tomllib.load(f)
        w = conf.get("settlement_worker_config", conf)
        return cls(
            proof_interval=float(w.get("proof_interval", 1.0)),
            verify_interval=float(w.get("verify_interval", 1.0)),
            rollup_interval=float(w.get("rollup_interval", 1.0)),
            watcher_interval=float(w.get("watcher_interval", 30.0)),
        )


def _loop(stop: threading.Event, interval: float, tick):
    while not stop.is_set():
        try:
            tick()
        except Exception:
            log.exception("worker tick failed")
        stop.wait(interval)


class L2Watcher:
    """batch_proposer/mod.rs: poll eth_blockNumber, mark Sequenced."""

    def __init__(self, db: Database, chain, interval: float = 30.0):
        self.db = db
        self.chain = chain
        self.interval = interval

    def tick(self):
        head = self.chain.block_number()
        prev = self.db.get_u64(KEY_LAST_SEQUENCE_FINALITY_BLOCK_NUMBER) or 0
        for n in range(prev + 1, head + 1):
            self.db.put_status(n, Status.Sequenced)
        if head > prev:
            self.db.put_u64(KEY_LAST_SEQUENCE_FINALITY_BLOCK_NUMBER, head)

    def start(self, stop: threading.Event) -> threading.Thread:
        t = threading.Thread(
            target=_loop, args=(stop, self.interval, self.tick), daemon=True
        )
        t.start()
        return t


# EIP-155 packing shared with the prover's chain executor (utils/rlp.py)
# so the proofs bind exactly the bytes this worker submits on-chain.
encode_legacy_tx = rlp.encode_legacy_tx


class Settler:
    """The three settlement-side workers (worker.rs:98-474)."""

    def __init__(
        self,
        db: Database,
        pipeline: ProverPipeline,
        settlement: Settlement,
        chain,
        chain_id: int,
        config: WorkerConfig | None = None,
    ):
        self.db = db
        self.pipeline = pipeline
        self.settlement = settlement
        self.chain = chain
        self.chain_id = chain_id
        self.config = config or WorkerConfig()

    # -- proof_worker (worker.rs:99-222) -------------------------------------

    def proof_tick(self):
        last_submitted = self.db.get_u64(KEY_LAST_SUBMITTED_BLOCK_NUMBER) or 0
        next_batch = self.db.get_u64(KEY_NEXT_BATCH)
        if next_batch is None:
            if last_submitted > 0:
                self.db.put_u64(KEY_NEXT_BATCH, 1)
            return
        if next_batch > last_submitted:
            return
        result = self.pipeline.execute(next_batch)
        self.db.put_proof(next_batch, result)
        self.db.put_u64(KEY_LAST_PROVEN_BLOCK_NUMBER, next_batch)
        self.db.put_u64(KEY_NEXT_BATCH, next_batch + 1)
        self.db.put_status(next_batch, Status.Batching)
        log.info("proved batch %d", next_batch)
        METRICS.inc("batches_proved")

    # -- verify_worker (worker.rs:224-313) -----------------------------------

    def verify_tick(self):
        last_proven = self.db.get_u64(KEY_LAST_PROVEN_BLOCK_NUMBER) or 0
        last_verified = self.db.get_u64(KEY_LAST_VERIFIED_BLOCK_NUMBER) or 0
        if last_proven <= last_verified:
            return
        n = last_verified + 1
        proof = self.db.get_proof(n)
        if proof is None:
            return
        exit_root = self.settlement.get_last_rollup_exit_root()
        last_batch = self.db.get_u64(KEY_LAST_VERIFIED_BATCH_NUMBER) or 0
        self.settlement.verify_batches(
            0,
            last_batch,
            last_batch + 1,
            exit_root,
            proof.post_state_root,
            proof.proof,
            proof.public_input,
        )
        self.db.put_u64(KEY_LAST_VERIFIED_BLOCK_NUMBER, n)
        self.db.put_u64(KEY_LAST_VERIFIED_BATCH_NUMBER, last_batch + 1)
        self.db.put_status(n, Status.Finalized)
        log.info("verified batch %d", n)
        METRICS.inc("batches_verified")

    # -- rollup submit worker (worker.rs:315-474) ----------------------------

    def rollup_tick(self):
        finality = self.db.get_u64(KEY_LAST_SEQUENCE_FINALITY_BLOCK_NUMBER) or 0
        last_submitted = self.db.get_u64(KEY_LAST_SUBMITTED_BLOCK_NUMBER) or 0
        last_verified = self.db.get_u64(KEY_LAST_VERIFIED_BLOCK_NUMBER) or 0
        if last_verified != last_submitted or finality <= last_submitted:
            return
        n = last_submitted + 1
        block = self.chain.get_block_by_number(n, True)
        if block is None:
            return
        txs = block.get("transactions") or []
        if not txs:
            # empty-block fast path (worker.rs:382-420): finalize with a
            # placeholder proof, bumping every watermark in strict order
            self.db.put_status(n, Status.Finalized)
            self.db.put_proof(
                n,
                ProofResult(block_number=n, proof="", public_input=""),
            )
            self.db.put_u64(KEY_LAST_SUBMITTED_BLOCK_NUMBER, n)
            self.db.put_u64(KEY_LAST_PROVEN_BLOCK_NUMBER, n)
            self.db.put_u64(KEY_LAST_VERIFIED_BLOCK_NUMBER, n)
            next_batch = self.db.get_u64(KEY_NEXT_BATCH) or 1
            self.db.put_u64(KEY_NEXT_BATCH, max(next_batch, n + 1))
            log.info("empty block %d finalized (fast path)", n)
            return
        data = b"".join(encode_legacy_tx(tx, self.chain_id) for tx in txs)
        ger = self.settlement.get_global_exit_root()
        batch = BatchData(
            transactions=data,
            global_exit_root=ger,
            timestamp=int(block.get("timestamp", "0x0"), 16)
            if isinstance(block.get("timestamp"), str)
            else int(block.get("timestamp", 0)),
        )
        self.settlement.sequence_batches([batch])
        self.db.put_u64(KEY_LAST_SUBMITTED_BLOCK_NUMBER, n)
        self.db.put_status(n, Status.Submitted)
        log.info("submitted block %d (%d txs)", n, len(txs))
        METRICS.inc("blocks_submitted")

    # -- lifecycle -----------------------------------------------------------

    def start_all(self, stop: threading.Event) -> list[threading.Thread]:
        cfg = self.config
        threads = [
            threading.Thread(
                target=_loop, args=(stop, cfg.proof_interval, self.proof_tick), daemon=True
            ),
            threading.Thread(
                target=_loop, args=(stop, cfg.verify_interval, self.verify_tick), daemon=True
            ),
            threading.Thread(
                target=_loop, args=(stop, cfg.rollup_interval, self.rollup_tick), daemon=True
            ),
        ]
        for t in threads:
            t.start()
        return threads
