"""The readings that the check's limits are set from, for one cell, in one
process on the card:

    python3 zkbench/control.py --workload <name> [--seeds 12] [--control-seeds 3]
                               [--first-seed N]

The lower reading: the program on `--seeds` seeds, one request each at the
cell's own size (after one warm-up request), every answer compared with the
plain reference.  The upper reading: the control, which is the reference
put in the program's place with one guarantee that the configuration states
broken, on `--control-seeds` seeds.  The configurations state no precision;
the guarantee broken is the query count of the step the cell drives (step
3's attestation queries, step 2's chunk queries), one query fewer, the
step that would tempt a faster prover.  The last line is a JSON object with
both readings of every compared number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from zkbench import harness  # noqa: E402
from zkbench import traffic as traffic_m  # noqa: E402
from zkbench.reference import service  # noqa: E402
from zkbench.reference import stark as ref_stark  # noqa: E402


class ReferenceProver:
    """The reference in the program's place, the query count of the step
    the cell drives cut by one: the prover service's two steps."""

    def __init__(self, config: dict, entry: str, device):
        p = config["prover"]
        self.config, self.device = config, device
        sp = dict(p["stark_params"])
        self.step2_params = ref_stark.StarkParams(**sp)
        if entry == "chunks":
            sp["num_queries"] -= 1
            self.step2_params = ref_stark.StarkParams(**sp)
        self.agg_queries = p["agg_queries"] - (1 if entry == "aggregate" else 0)

    def gen_chunk_proof(self, batch_id, task_id, chunk_count, chain_id, program_name,
                        batch_data):
        p = self.config["prover"]
        kids = service.chunk_proofs(batch_data, task_id, chunk_count, chain_id,
                                    self.step2_params, p["chunk_trace_rows"],
                                    self.config["chunk_elems"], device=self.device)
        return SimpleNamespace(result_code=0, error_message="",
                               chunk_proofs=[SimpleNamespace(**k) for k in kids])

    def gen_aggregated_proof(self, batch_id, proof_1, proof_2):
        agg = service.aggregate(proof_1, proof_2, self.agg_queries, device=self.device)
        return SimpleNamespace(result_code=0, error_message="", result_string=json.dumps(agg))


def reading(drv, mod, cell: dict, seed: int, device) -> dict:
    """One request of `seed` through the driver, checked against the
    reference as a run checks it (harness.compare)."""
    req = traffic_m.request(seed, 1, cell["traffic"], cell["config"])
    t = time.perf_counter()
    ok, answers, error = drv.answers(drv.call(drv.prepare(req)))
    t_call = time.perf_counter() - t
    t = time.perf_counter()
    differing, worked = harness.compare(mod, seed, 1, [harness.digest(a) for a in answers],
                                        cell["traffic"], cell["config"], device)
    return {"seed": seed, "requests_failed": int(not ok), "answers_differing": differing,
            "answers_worked_out": worked, "call_s": t_call,
            "reference_s": time.perf_counter() - t, "error": error}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=(1 << 31) + 7000)
    args = ap.parse_args(argv)

    import importlib

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("control: needs a CUDA device")
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    entry = cell["traffic"]["entry"]
    mod = importlib.import_module(f"zkbench.entries.{entry}")
    seeds = [args.first_seed + 101 * i for i in range(args.seeds)]

    drv = harness.driver_for(cell, harness.make_prover(cell["config"], device), device)
    warm = traffic_m.request(seeds[0], 0, cell["traffic"], cell["config"])
    drv.answers(drv.call(drv.prepare(warm)))
    program = []
    for seed in seeds:
        program.append(reading(drv, mod, cell, seed, device))
        print(json.dumps({"program": program[-1]}), flush=True)
    del drv
    torch.cuda.empty_cache()

    ctl = harness.driver_for(cell, ReferenceProver(cell["config"], entry, device), device)
    control = []
    for seed in seeds[: args.control_seeds]:
        control.append(reading(ctl, mod, cell, seed, device))
        print(json.dumps({"control": control[-1]}), flush=True)

    summary = {}
    for key in ("requests_failed", "answers_differing"):
        summary[key] = {"lower": max(r[key] for r in program),
                        "upper": min(r[key] for r in control)}
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(device),
                      "seeds": seeds, "control_seeds": seeds[: args.control_seeds],
                      "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
