"""Global environment config — copy of eigen_zeth_tpu/utils/config.py.

The reference's GLOBAL_ENV (src/config/env.rs:19-35): a lazy singleton of
environment variables with the same names and defaults.  DEBUG_PROOF=TRUE
swaps the prover for the canned reference vectors
(src/settlement/worker.rs:49-96).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass


@dataclass(frozen=True)
class GlobalEnv:
    l2_addr: str
    prover_addr: str
    curve_type: str
    chain_id: int
    program_name: str
    bridge_service_addr: str
    debug_proof: bool
    fork_id: int


@functools.lru_cache(maxsize=1)
def global_env() -> GlobalEnv:
    return GlobalEnv(
        l2_addr=os.environ.get("ZETH_L2_ADDR", "http://127.0.0.1:8546"),
        prover_addr=os.environ.get("PROVER_ADDR", "http://127.0.0.1:50061"),
        curve_type=os.environ.get("CURVE_TYPE", "BN128"),
        chain_id=int(os.environ.get("CHAIN_ID", "12345")),
        program_name=os.environ.get("PROGRAM_NAME", "EVM").lower(),
        bridge_service_addr=os.environ.get("BRIDGE_SERVICE_ADDR", "http://localhost:8001"),
        debug_proof=os.environ.get("DEBUG_PROOF", "").upper() == "TRUE",
        fork_id=int(os.environ.get("FORK_ID", "0")),
    )
