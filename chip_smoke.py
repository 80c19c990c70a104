#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the batch proof (`eigen_zeth_tpu_torch`,
`BatchProver(wrap="mimc", recursion=False)`), through its four
ProverService steps on the card, and checks every stage:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions
  2. builds the CUDA kernels from eigen_zeth_tpu_torch/csrc with nvcc
  3. holds each kernel against its plain PyTorch version, bit for bit, at
     the slice's shapes, and times both (CUDA events, median)
  4. proves the tiny golden configuration on the card and checks its
     sha256 digests against tests/data/torch_slice_golden.json
  5. proves the slice: 7,200 synthetic blocks (9 chunks of 4,096-row
     traces), default StarkParams, the MiMC Groth16 wrap; checks every
     chunk proof with verify_chunk and the final proof with groth16.verify,
     and requires that both kernels were launched in that run

It prints a JSON line with each kernel's numbers, then, as its last line,
{"ok": true, "device": {...}}.  Any failed check raises; without a CUDA
device it exits non-zero before proving anything.
"""

from __future__ import annotations

import base64
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from eigen_zeth_tpu_torch.models import groth16, stark
from eigen_zeth_tpu_torch.ops import bn254, kernels
from eigen_zeth_tpu_torch.protocol import prover_service as ps
from eigen_zeth_tpu_torch.protocol.messages import ProofResultCode

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_slice_golden.json"
SLICE_BLOCKS = 7200
MSM_POINTS = 1326  # variables of the MiMC wrap circuit
KERNEL_BATCH = 32 * MSM_POINTS  # 32 windows of c = 8 over the MSM's points
CHAIN_ID = 12345
AGGREGATOR = "0x" + "11" * 20


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """Median time of fn() on the card over reps runs (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _check(result) -> None:
    if result.result_code != ProofResultCode.COMPLETED_OK:
        raise AssertionError(f"{type(result).__name__}: {result.error_message}")


def drive(prover, blocks):
    """The four steps, in the order the node's state machine drives them;
    step 3 aggregates the first and last chunk proofs."""
    times = {}
    t = time.perf_counter()
    r1 = prover.gen_batch_chunks("smoke", blocks, CHAIN_ID, "evm")
    times["gen_batch_chunks"] = time.perf_counter() - t
    _check(r1)
    t = time.perf_counter()
    r2 = prover.gen_chunk_proof("smoke", r1.task_id, r1.chunk_count, CHAIN_ID, "evm", r1.batch_data)
    torch.cuda.synchronize()
    times["gen_chunk_proof"] = time.perf_counter() - t
    _check(r2)
    t = time.perf_counter()
    r3 = prover.gen_aggregated_proof("smoke", r2.chunk_proofs[0].proof, r2.chunk_proofs[-1].proof)
    times["gen_aggregated_proof"] = time.perf_counter() - t
    _check(r3)
    t = time.perf_counter()
    r4 = prover.gen_final_proof("smoke", r3.result_string, "BN128", AGGREGATOR)
    torch.cuda.synchronize()
    times["gen_final_proof"] = time.perf_counter() - t
    _check(r4)
    return r1, r2, r3, r4, times


def phase_environment() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — this run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")


def phase_build() -> None:
    t = time.perf_counter()
    kernels.build()
    log(f"[build] kernels built in {time.perf_counter() - t:.1f} s")
    for line in kernels.ptxas_report().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")


def _random_fq(rng, n: int) -> list[int]:
    return [int.from_bytes(rng.bytes(32), "little") % bn254.Q for _ in range(n)]


def phase_kernels(device) -> dict:
    """Each kernel against its plain version on the same inputs, bit for bit."""
    rng = np.random.default_rng(2024)
    ctx = bn254.fq()
    Q = bn254.Q
    results = {}

    va, vb = _random_fq(rng, KERNEL_BATCH), _random_fq(rng, KERNEL_BATCH)
    va[:4], vb[:4] = [0, 1, Q - 1, Q - 2], [Q - 1, Q - 1, Q - 1, 0]
    a, b = ctx.from_int(va, device), ctx.from_int(vb, device)
    got = kernels.mont_mul(ctx, a, b)
    ref = kernels.mont_mul_plain(ctx, a, b)
    err = int((got.long() - ref.long()).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"mont_mul disagrees with its plain version (max abs err {err})")
    results["mont_mul"] = {
        "max_abs_err": err,
        "ms": cuda_time_ms(lambda: kernels.mont_mul(ctx, a, b), 50),
        "plain_ms": cuda_time_ms(lambda: kernels.mont_mul_plain(ctx, a, b), 10),
    }

    # real points for the degenerate cases: P+P, P+(-P), inf+P, P+inf
    pts = [bn254.h_ec_mul(k, bn254.G1_GEN) for k in range(1, 7)]
    P = pts + [pts[0], pts[1], None, pts[2], None]
    Qp = pts[::-1] + [pts[0], (pts[1][0], (-pts[1][1]) % Q), pts[3], None, None]

    def coords(points, n_rand):
        xs = [p[0] if p else 0 for p in points] + _random_fq(rng, n_rand)
        ys = [p[1] if p else 0 for p in points] + _random_fq(rng, n_rand)
        zs = [0 if p is None else 1 for p in points] + _random_fq(rng, n_rand)
        return tuple(ctx.from_int(v, device) for v in (xs, ys, zs))

    p = coords(P, KERNEL_BATCH - len(P))
    q = coords(Qp, KERNEL_BATCH - len(Qp))
    got3 = kernels.point_add(ctx, p, q)
    ref3 = kernels.point_add_plain(ctx, p, q)
    err = max(int((g.long() - r.long()).abs().max()) for g, r in zip(got3, ref3))
    if not all(torch.equal(g, r) for g, r in zip(got3, ref3)):
        raise AssertionError(f"point_add disagrees with its plain version (max abs err {err})")
    # the edge cases mean what they should: affine results against host math
    ax, ay = bn254.to_affine(bn254.FqOps(), bn254.PointJ(*(t[:, : len(P)] for t in got3)))
    xs, ys = ctx.to_int(ax), ctx.to_int(ay)
    for i, (u, v) in enumerate(zip(P, Qp)):
        want = bn254.h_ec_add(u, v)
        have = None if (want is None and xs[i] == 0 and ys[i] == 0) else (int(xs[i]), int(ys[i]))
        if have != want:
            raise AssertionError(f"point_add edge case {i} is wrong")
    results["point_add"] = {
        "max_abs_err": err,
        "ms": cuda_time_ms(lambda: kernels.point_add(ctx, p, q), 50),
        "plain_ms": cuda_time_ms(lambda: kernels.point_add_plain(ctx, p, q), 5),
    }
    for name, r in results.items():
        log(f"[kernels] {name}: bit-exact vs plain at (16, {KERNEL_BATCH}); "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    return results


def _sha(s: str) -> str:
    return hashlib.sha256(s.encode()).hexdigest()


def phase_golden(device) -> None:
    golden = json.loads(GOLDEN.read_text())
    cfg = golden["config"]
    prover = ps.BatchProver(
        stark_params=stark.StarkParams(**cfg["stark_params"]),
        wrap=cfg["wrap"],
        chunk_trace_rows=cfg["chunk_trace_rows"],
        groth16_seed=cfg["groth16_seed"],
        device=device,
    )
    t = time.perf_counter()
    prover.verifying_key  # the deterministic MiMC CRS: host setup, once per process
    log(f"[golden] Groth16 CRS setup (host): {time.perf_counter() - t:.2f} s")
    _, r2, r3, r4, _ = drive(prover, cfg["blocks"])
    got = {
        "chunk_proofs": [_sha(c.proof) for c in r2.chunk_proofs],
        "aggregated": _sha(r3.result_string),
        "final_proof": _sha(r4.final_proof.proof),
        "public_input": _sha(r4.final_proof.public_input),
    }
    if got != golden["sha256"]:
        raise AssertionError(f"golden mismatch: {got} != {golden['sha256']}")
    log("[golden] tiny configuration on the card: all sha256 digests match")


def phase_slice(device) -> dict:
    prover = ps.BatchProver(wrap="mimc", recursion=False, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    r1, r2, r3, r4, times = drive(prover, list(range(1, SLICE_BLOCKS + 1)))
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)

    if r1.chunk_count != 9 or len(r2.chunk_proofs) != 9:
        raise AssertionError(f"expected 9 chunks, got {r1.chunk_count}")
    for c in r2.chunk_proofs:
        proof = json.loads(c.proof)["stark"]
        if proof["n"] != 4096 or not stark.verify_chunk(proof, prover.stark_params):
            raise AssertionError(f"chunk proof {c.chunk_id} does not verify")
    pub = [int(x) for x in json.loads(r4.final_proof.public_input)]
    if not groth16.verify(prover.verifying_key, json.loads(r4.final_proof.proof), pub):
        raise AssertionError("the final Groth16 proof does not verify")
    if len(base64.b64decode(r1.batch_data)) != 32 * SLICE_BLOCKS + 64:
        raise AssertionError("unexpected batch payload size")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    log(f"[slice] {SLICE_BLOCKS} blocks, {r1.chunk_count} chunks of 4096 rows, mimc wrap")
    for step, s in times.items():
        log(f"[slice] {step}: {s:.3f} s")
    log(f"[slice] total of the four steps: {sum(times.values()):.3f} s")
    log(f"[slice] max_memory_allocated: {peak / 2**20:.1f} MiB")
    log(f"[slice] launches: {launches}")
    log("[slice] 9/9 chunk proofs pass verify_chunk; the final proof passes groth16.verify")
    return launches


def main() -> int:
    t0 = time.perf_counter()
    phase_environment()
    device = torch.device("cuda")
    phase_build()
    timing = phase_kernels(device)
    phase_golden(device)
    launches = phase_slice(device)
    rows = [
        {"name": name, **kernels.KERNELS[name], "launches": launches[name], **timing[name]}
        for name in kernels.KERNELS
    ]
    log(f"[smoke] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
