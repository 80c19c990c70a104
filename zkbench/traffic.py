"""The one generator of request inputs.  A traffic mix is a data file,
`zkbench/traffic/<name>.json`, whose parameters this module reads:

  entry          the driver in zkbench/entries/ that sends the requests
  payload_bytes  bytes of a request's payload; packed 7 bytes an element
                 into chunks of the configuration's chunk_elems elements,
                 the last one partial where the bytes leave it so
  warmup         requests sent before the window (set-up); the last one's
                 time sizes the pool of inputs
  check          requests of the window that the reference works out again,
                 drawn from the seed
The window is a closed loop with one request in flight (zkbench/harness.py).

Every request i (0 for the first warm-up request) gets its own payload and
task id from (seed, i), so no two requests of a run, warm-up included, see
the same payload, task id or chunk proof keys, and the same seed gives the
same inputs.
"""

from __future__ import annotations

import base64
import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

BYTES_PER_ELEM = 7  # 2^56 < p: the prover service's packing


@dataclass(frozen=True)
class Request:
    index: int
    batch_id: str
    task_id: str
    chunk_count: int
    batch_data: str  # base64, as the prover service takes it


def load(root: Path, name: str) -> dict:
    with open(root / "traffic" / f"{name}.json") as f:
        return json.load(f)


def chunk_count(traffic: dict, config: dict) -> int:
    """The chunks a payload of the mix fills, as the prover service packs it."""
    return math.ceil(math.ceil(traffic["payload_bytes"] / BYTES_PER_ELEM) / config["chunk_elems"])


def request(seed: int, index: int, traffic: dict, config: dict) -> Request:
    """The inputs of request `index` of a run with `seed`."""
    rng = np.random.default_rng([seed, index])
    data = rng.bytes(traffic["payload_bytes"])
    # a task id of its own for every request: 40 random bits above the index
    task = (int(rng.integers(1, 1 << 40)) << 20) | index
    return Request(index=index, batch_id=f"zkbench-{seed}-{index}", task_id=str(task),
                   chunk_count=chunk_count(traffic, config),
                   batch_data=base64.b64encode(data).decode())


def sample(seed: int, n_done: int, k: int) -> list[int]:
    """k of the window's n_done requests (their positions), drawn from the
    seed; the last one always among them."""
    if n_done == 0:
        return []
    rng = np.random.default_rng([seed, 1 << 31])
    rest = rng.permutation(n_done - 1)[: max(0, k - 1)]
    return sorted({n_done - 1, *(int(i) for i in rest)})
