"""Operator — constructs the prover pipeline + settlement provider and
supervises the worker set.

A copy of eigen_zeth_tpu/operator.py (the mirror of src/operator.rs:21-118):
build the in-process ProverPipeline over a batch prover, start the L2
watcher, spawn the verify/proof/rollup workers with a shared stop signal,
and fan the stop out on shutdown.  The prover is the port's `BatchProver`
on a named device or a `RemoteBatchProver`; the caller makes it (the JAX
class's default, an in-process prover on the TPU, has no counterpart here:
a prover of the port names its device).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from .protocol.kv import Database
from .protocol.state_machine import ProverPipeline
from .settlement.interface import Settlement
from .settlement.worker import L2Watcher, Settler, WorkerConfig
from .utils.config import global_env


@dataclass
class Operator:
    db: Database
    chain: object  # JSON-RPC client (or mock) for the L2
    settlement: Settlement
    prover: object  # BatchProver or RemoteBatchProver
    worker_config: WorkerConfig = field(default_factory=WorkerConfig)
    aggregator_addr: str = ""

    def __post_init__(self):
        env = global_env()
        self.pipeline = ProverPipeline(
            self.db, self.prover, aggregator_addr=self.aggregator_addr
        )
        self.settler = Settler(
            db=self.db,
            pipeline=self.pipeline,
            settlement=self.settlement,
            chain=self.chain,
            chain_id=env.chain_id,
            config=self.worker_config,
        )
        self.watcher = L2Watcher(
            self.db, self.chain, interval=self.worker_config.watcher_interval
        )
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def run(self) -> None:
        """Start all workers (operator.rs:55-104)."""
        self._threads.append(self.watcher.start(self._stop))
        self._threads.extend(self.settler.start_all(self._stop))

    def stop(self, timeout: float = 10.0) -> None:
        """Stop fan-out (operator.rs:107-116)."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout)

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()
