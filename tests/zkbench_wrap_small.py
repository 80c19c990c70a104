"""The cell attest-wrap.stark-wrap-2leaf-grpc.wrap-pair at a small shape,
for the CPU tests of the benchmark's wrap-profile entry, reference and check.

The shape: 8-row chunks of 7 elements, StarkParams(4, 2, 16) (one FRI fold
layer in the child, as at the node's shape), and the wrap profile at 2
queries, 4 grinding bits and blowup 8.  The cell's payload is scaled with
the chunk, so a request still fills two full chunks.

The port proves a wrap attestation on a CPU tensor with its host Poseidon2-Fr
commits, about 150 s an attestation at this shape, so the attestations that
the tests' runs need are kept in `DATA`, made by the port's own
`recursion.attest_chunk_wrap` on the children of requests 0, 1 and 2 of
`SEED` (the warm-up request and the pool of two that a run with a window of
50 ms prepares), at the cell's wrap profile and with one wrap
query fewer (the control).  `use_store`
puts the store in the place of `attest_chunk_wrap`: a child it does not hold
raises, so a change to the children or the profile fails the tests that
lean on it.  Everything else of a run is live: step 2, the gRPC stream, the
envelope, the plain verifier and the reference.  `DATA` also holds the plain
reference's constants root at this shape.  Rewrite it with

    PYTHONPATH=. python tests/zkbench_wrap_small.py     # about 10 minutes, 4 processes
"""

from __future__ import annotations

import copy
import gzip
import hashlib
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELL = "attest-wrap.stark-wrap-2leaf-grpc.wrap-pair"
SEED = (1 << 31) + 1213
ELEMS = 7
PROVER = {
    "chunk_trace_rows": 8,
    "stark_params": {"blowup": 4, "num_queries": 2, "terminal_size": 16},
    "wrap_queries": 2,
    "wrap_grind_bits": 4,
    "wrap_blowup": 8,
}
REQUESTS = (0, 1, 2)  # the warm-up request and the pool of a short window
DATA = ROOT / "tests" / "data" / "zkbench_wrap_small.json.gz"


def small_cell(with_root: bool = True) -> dict:
    """The cell at the small shape; its configuration's `constants_root`
    the plain reference's at that shape (from `DATA`)."""
    from zkbench import harness
    from zkbench import traffic as traffic_m

    cell = copy.deepcopy(harness.load_cell(CELL))
    config, traffic = cell["config"], cell["traffic"]
    chunks = traffic_m.chunk_count(traffic, config)
    traffic["payload_bytes"] = math.ceil(traffic["payload_bytes"] * ELEMS / config["chunk_elems"])
    config["prover"].update(copy.deepcopy(PROVER))
    config["chunk_elems"] = ELEMS
    for key, g in (("wrap_queries", "wrap_queries"), ("wrap_grind_bits", "wrap_grind_bits"),
                   ("wrap_blowup", "wrap_blowup")):
        config["guarantees"][g] = PROVER[key]
    config["guarantees"]["chunk_queries"] = PROVER["stark_params"]["num_queries"]
    assert traffic_m.chunk_count(traffic, config) == chunks == 2
    if with_root:
        config["constants_root"] = store()["constants_root"]
    return cell


def key(child: dict, queries: int, grind_bits: int, blowup: int) -> str:
    digest = hashlib.sha256(json.dumps(child, sort_keys=True).encode()).hexdigest()
    return f"{digest}/{queries}/{grind_bits}/{blowup}"


_STORE: dict = {}


def store() -> dict:
    if not _STORE:
        with gzip.open(DATA, "rt") as f:
            _STORE.update(json.load(f))
    return _STORE


def use_store(monkeypatch) -> None:
    """The port's wrap attestations of the store in the place of
    `recursion.attest_chunk_wrap` (a child it does not hold raises)."""
    from eigen_zeth_tpu_torch.models import recursion

    held = store()["attestations"]

    def attest_chunk_wrap(child_proof, num_queries_wrap=2, grind_bits=0, ext_blowup=8, *,
                          device):
        k = key(child_proof, num_queries_wrap, grind_bits, ext_blowup)
        if k not in held:
            raise KeyError(f"no stored wrap attestation for {k}")
        return json.loads(held[k])

    monkeypatch.setattr(recursion, "attest_chunk_wrap", attest_chunk_wrap)


def children(cell: dict, index: int) -> list:
    """The port's step-2 chunk proofs (the children) of request `index`."""
    import torch

    from zkbench import harness
    from zkbench import traffic as traffic_m

    config = cell["config"]
    prover = harness.make_prover(config, torch.device("cpu"))
    req = traffic_m.request(SEED, index, cell["traffic"], config)
    r = prover.gen_chunk_proof(req.batch_id, req.task_id, req.chunk_count, config["chain_id"],
                               config["program_name"], req.batch_data)
    assert r.result_code == 0, r.error_message
    return [json.loads(c.proof)["stark"] for c in r.chunk_proofs]


def run(cell: dict, traced: bool = False, prover=None, seconds: float = 0.05) -> dict:
    """One run of the cell through the harness on the CPU; traced, under the
    host's profiler, as the CPU has no card.  A sound warm-up takes seconds
    (the plain verifier), so the pool it sizes for a 50 ms window holds two
    requests, and the window runs one or both.  A window of 5 ms starts one
    request or two of some milliseconds each, whatever the warm-up: the
    control's, whose warm-up is rejected in milliseconds, and a traced run
    that keeps to one."""
    import time

    import torch

    from zkbench import harness, trace

    card = trace.Profiler
    if traced:
        trace.Profiler = _cpu_profiler(card)
    try:
        return harness.run_cell(cell, SEED, seconds, traced, torch.device("cpu"),
                                t_start=time.perf_counter(), prover=prover, log=lambda m: None)
    finally:
        trace.Profiler = card


def _cpu_profiler(card):
    from torch.profiler import ProfilerActivity, profile

    class CpuProfiler(card):
        """The harness's profiler with the host's activity: the program's
        tracer records under it as under the card's."""

        def __init__(self):
            self._prof = profile(activities=[ProfilerActivity.CPU])

        def ops(self) -> list:
            return []

    return CpuProfiler


def _attest(job):
    import torch

    from eigen_zeth_tpu_torch.models import recursion

    torch.set_num_threads(1)
    child, queries = job
    p = PROVER
    att = recursion.attest_chunk_wrap(child, num_queries_wrap=queries,
                                      grind_bits=p["wrap_grind_bits"],
                                      ext_blowup=p["wrap_blowup"], device=torch.device("cpu"))
    return key(child, queries, p["wrap_grind_bits"], p["wrap_blowup"]), json.dumps(att)


def _constants_root(_):
    import torch

    from zkbench.reference import air_wrap, recursion

    torch.set_num_threads(1)
    cell = small_cell(with_root=False)
    p = cell["config"]["prover"]
    sp = p["stark_params"]
    rows = p["chunk_trace_rows"]
    air = air_wrap.wrap_air(recursion.attestation_air(
        rows, sp["num_queries"], min(sp["terminal_size"], 4 * rows))[0], p["wrap_blowup"])
    return str(air_wrap.constants_root_host(air))


def generate() -> None:
    import multiprocessing as mp

    cell = small_cell(with_root=False)
    jobs = [(child, q) for index in REQUESTS for child in children(cell, index)
            for q in (PROVER["wrap_queries"], PROVER["wrap_queries"] - 1)]
    with mp.get_context("spawn").Pool(4) as pool:
        root = pool.apply_async(_constants_root, (None,))
        atts = dict(pool.map(_attest, jobs, chunksize=1))
        data = {"seed": SEED, "prover": PROVER, "constants_root": root.get(),
                "attestations": atts}
    with gzip.open(DATA, "wt") as f:
        json.dump(data, f, sort_keys=True)
    print(f"wrote {DATA}: {len(atts)} attestations, constants root {data['constants_root']}")


if __name__ == "__main__":
    generate()
