#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths (`eigen_zeth_tpu_torch`) on the card through
the entry points a user calls, and checks every stage:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions
  2. builds the CUDA kernels from eigen_zeth_tpu_torch/csrc with nvcc and
     times the integer-rate probe beside the rate the bounds assume
  3. holds each kernel against its plain PyTorch version, bit for bit, at
     its path's shape (A and B at 32 windows x 1,326 MSM points, C and D at
     20 windows x 8,192 lanes, the power at 32 window sums, the G2 add at
     32 windows x 896 points; the point adds also under a mask, all set,
     none set and mixed, for both kept operands; kernel E, Poseidon2 over
     Goldilocks, through its four entry points: the sponge over the
     attestation trace's 2^21 rows of 216 columns as the AIR prover hands
     them over, column-major, and over FRI's 2^20 pairs, a Merkle level of
     2^20 strided digest pairs, 2^18 bare permutations with states aimed at
     the lazy field core's bounds, a whole 2^21-leaf tree in one launch and
     9 batched trees of 2^14 leaves; kernel F, Poseidon2 over BN254 Fr,
     through its three entry points: the grind search's 2^14 states with
     edge lanes, the leaf sponge over the wrap attestation's 2^23 rows of
     216 columns, column-major, and its whole 2^23-leaf tree in one launch),
     with edge cases checked against host arithmetic.  Three times per kernel: at the path's shape
     (CUDA events around runs of back-to-back launches, median), the
     host's cost of a launch (host clock around 200 launches, nothing
     synchronised inside), and the device time at a batch where the card's
     work outlasts the host's enqueue, beside the bound worked out from
     the bytes and multiply-adds at that batch.  Checks that kernel C
     equals sign select, kernel D, restart select
  4. proves the two tiny golden configurations on the card (recursion off
     and on) and checks their sha256 digests against
     tests/data/torch_slice_golden.json; makes the CRS of the tiny STARK
     wrap and proves it, against tests/data/torch_stark_wrap_golden.json
  5. the batch proof, `BatchProver(wrap="mimc", recursion=False)`: 7,200
     synthetic blocks (9 chunks of 4,096-row traces), default StarkParams,
     the MiMC Groth16 wrap; checks every chunk proof with verify_chunk and
     the final proof with groth16.verify
  6. the fast G1 MSM at 2^18 distinct points, c = 13, serial 32, window
     group 32: `bad` is False, the result equals one host scalar
     multiplication of G by Σ s_i·k_i, kernel C was launched 32 times; then
     a small input with a duplicated point, where `bad` rises and the
     result still equals the host's
  7. KZG: a 4,096-point SRS made on the card, commit and opening of a
     4,096-coefficient polynomial, verify True, a wrong value False
  8. the unsafe mixed add through `bn254.point_madd_unsafe` (kernel D) on
     2^17 pairs of distinct points, against the complete add and the host
  9. the batch proof with recursive aggregation, as a node runs it:
     `BatchProver(recursion=True, wrap="mimc")` at the production chunk shape
     (4,096-row chunks, blowup 4, 32 queries, terminal 64, 30 queries of the
     attestation STARK), 1,600 synthetic blocks (2 chunks): step 3 attests
     each chunk with the verifier AIR (a 2^18-row trace of 216 columns,
     extended to 2^21, one Merkle tree over the wide rows) and is timed by
     stage; checks every chunk proof with verify_chunk, every attestation
     with recursion.verify_attestation under the pinned shape, the
     aggregated digest, the final proof with groth16.verify, and that
     kernel E was launched in steps 2 and 3, at most 60 times an
     attestation
 10. the node's default, sound final wrap at the node's configuration:
     `BatchProver(recursion=True, wrap="stark")`, the production chunk shape
     and wrap profile (11 queries, 12 grinding bits, blowup 32, two
     leaves), 1,600 blocks (2 chunks).  `ensure_wrap_crs` first, into a
     scratch directory, timed by stage; then the four steps, step 3 by
     stage, step 4 by part; checks every chunk proof, every wrap
     attestation with verify_attestation_wrap under the pinned profile, the
     public input against the statement hash of the headers,
     groth16.verify under the pinned VK, a forged pi_c rejected, a
     corrupted attestation giving COMPLETED_ERROR, the device fixed-base
     against the host's on 2^14 G1 and 2^10 G2 scalars, and kernel F
     launched in step 3 (at most F_STEP3_MOST times)

Before each of the paths 5-10 the launch counts are set to 0, and read just
after: every kernel of that path must have been launched, and Montgomery
multiplies must stay few (a power is one launch, not one per squaring).
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

from eigen_zeth_tpu_torch.models import air, groth16, kzg, merkle, recursion, stark
from eigen_zeth_tpu_torch.ops import bn254, kernels, msm, poseidon
from eigen_zeth_tpu_torch.ops import goldilocks as gl
from eigen_zeth_tpu_torch.protocol import prover_service as ps
from eigen_zeth_tpu_torch.protocol.messages import ProofResultCode

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_slice_golden.json"
SLICE_BLOCKS = 7200
MSM_POINTS = 1326  # variables of the MiMC wrap circuit
KERNEL_BATCH = 32 * MSM_POINTS  # 32 windows of c = 8 over the MSM's points
MSM_LOG2 = 18  # the fast MSM's size: 2^18 points
MSM_C, MSM_SERIAL, MSM_GROUP = 13, 32, 32
STEP_BATCH = 20 * (1 << MSM_LOG2) // MSM_SERIAL  # 20 windows x 8,192 lanes: kernel C's batch
POW_BATCH = 32  # window sums that one to_affine inverts
G2_POINTS = 896  # the wrap circuit's 884 G2 points, padded to full serial lanes
G2_BATCH = 32 * G2_POINTS
# batches for the device times: the card's work must outlast the host's
# enqueue, and the operands must not fit the 50 MB L2 cache
BIG_FIELD, BIG_POINT = 1 << 20, 1 << 18
KZG_SIZE = 4096  # coefficients of one EIP-4844 blob
# the recursion tier: 1,600 blocks are 2 chunks of 4,096 rows, one aggregation
# pair; the attestation trace's LDE is 2^21 rows of 216 columns
RECURSION_BLOCKS = 1600
ATT_ROWS, ATT_COLS = 1 << 21, 216
E_PLAIN_ROWS = 1 << 12  # rows of the wide matrix that the plain version hashes
E_PERM_BATCH = 1 << 18
E_EDGE = 256  # states of edge lanes among them
E_CHUNK_LEAVES = 1 << 14  # a chunk STARK's leaves: 4,096 rows at blowup 4
E_ATTESTATION_MOST = 60  # kernel E launches one attestation may take
CHAIN_ID = 12345

# The card's peak rates for the bounds (NVIDIA H100 SXM data sheet): device
# memory 3.35 TB/s; 32-bit integer multiply-adds at a quarter of the
# 67 TFLOP/s float32 figure, which counts two operations per FMA on 128
# lanes per SM where the integer pipe has 64 lanes and one multiply-add each.
HBM_BYTES_PER_S = 3.35e12
INT32_MADS_PER_S = 67e12 / 4
MADS_PER_MONT_MUL = 8 * 8 + 8 * 8 + 8  # a·b, m·q and the eight m = t0·n0
MADS_PER_MONT_SQR = 36 + 8 * 8 + 8  # 28 cross terms once and 8 squares, then as above
POW_EXPONENT = bn254.Q - 2  # Fermat inversion, the power the paths take
# per element: bytes moved (each (16,) int32 limb plane 64 B, each mask 4 B,
# inputs read once, outputs written once), Montgomery products and Montgomery
# squarings (the dedicated squaring needs fewer multiply-adds).  The point
# adds count the generic add, the least the function needs: 11 products and
# 5 squarings for G1; over Fq2 three Fq products to a product and two to a
# squaring, all of them real products.  The mixed add of C and D is 7
# products and 4 squarings.  The power counts one squaring per bit below the
# top one and one product per set bit below it.  Under a mask the passed
# elements move their 6 (G2: 12) planes and take no product: `bound` scales
# the work by the share of elements that are added.
KERNEL_WORK = {
    "mont_mul": (3 * 64, 1, 0),
    "point_add": (9 * 64, 11, 5),
    "point_scan_step": (8 * 64 + 3 * 4, 7, 4),
    "point_madd": (8 * 64 + 4, 7, 4),
    "mont_pow": (2 * 64, bin(POW_EXPONENT).count("1") - 1, POW_EXPONENT.bit_length() - 1),
    "point_add_g2": (18 * 64, 11 * 3 + 5 * 2, 0),
    "point_add_masked": (9 * 64 + 4, 11, 5),
    "point_add_g2_masked": (18 * 64 + 4, 11 * 3 + 5 * 2, 0),
}
# Kernel E: a Goldilocks product is four 32 x 32 wide multiply-adds (the
# 128-bit product; the fold is shifts, adds and compares), a squaring three
# (the cross product once).  A permutation is 736 products: 8 full rounds x
# 12 lanes x 4 and 22 partial rounds x (4 + 12), where each of the 118
# S-boxes (x^7 = x^4·x^3) squares twice: 236 squarings and 500 products.
MADS_PER_GL_MUL = 4
MADS_PER_GL_SQR = 3
GL_SQRS_PER_PERM = 2 * (8 * 12 + 22)
GL_MULS_PER_PERM = 8 * 12 * 4 + 22 * (4 + 12) - GL_SQRS_PER_PERM
MADS_PER_PERM = GL_MULS_PER_PERM * MADS_PER_GL_MUL + GL_SQRS_PER_PERM * MADS_PER_GL_SQR
# the wide multiply-add rate that the probe measures in this run (phase_build)
PROBED_MADS_PER_S = {"rate": INT32_MADS_PER_S}
AGGREGATOR = "0x" + "11" * 20
# Kernel F, Poseidon2 over BN254 Fr: 8 full rounds x 12 S-boxes and 68
# partial rounds x 1, each S-box x^5 = two Montgomery squarings and one
# product, and 68 x 12 products by the internal diagonal: 980 products of 136
# multiply-adds and 328 squarings of 108 (bn254_field.cuh), the least the
# permutation needs.  The conversions into and out of Montgomery form at the
# kernel's boundary are not counted.
FR_MULS_PER_PERM = 8 * 12 + 68 * (1 + 12)
FR_SQRS_PER_PERM = 2 * (8 * 12 + 68)
MADS_PER_PERM_FR = FR_MULS_PER_PERM * MADS_PER_MONT_MUL + FR_SQRS_PER_PERM * MADS_PER_MONT_SQR
# the wrap-profile attestation at the node's profile: the verifier AIR's
# 2^18 x 216 trace at blowup 32, LDE 2^23 rows, 72 packed Fr elements a row
WRAP_ROWS = 1 << 23
WRAP_PERMS_PER_ROW = -(-(ATT_COLS // 3) // 11)  # 72 packed elements at rate 11: 7
F_PLAIN_ROWS = 1 << 10  # rows the plain version hashes
F_PLAIN_LEAVES = 1 << 10  # leaves of the subtree the plain version commits
F_GRIND_BATCH = 1 << 14  # states of one batch of the card's grind search
F_BIG_PERM = 1 << 18
F_STEP3_MOST = 100  # kernel F launches step 3 may take (2 attestations)
STARK_WRAP_BLOCKS = 1600  # 2 chunks: one aggregation pair, the final circuit's two leaves
STARK_GOLDEN = ROOT / "tests" / "data" / "torch_stark_wrap_golden.json"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int, groups: int = 3) -> float:
    """Time of one fn() on the card in ms: the median over `groups` runs of
    `reps` back-to-back calls, each run between two CUDA events, after one
    warm-up call.  Back to back, the host's cost of enqueueing a call
    overlaps the card's work on the one before.  The inputs stay the same,
    so whatever fits the 50 MB L2 cache is found there."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_us_per_launch(fn, reps: int = 200) -> float:
    """The host's cost of one fn() in microseconds: host clock around `reps`
    calls with no synchronisation inside (the card works behind)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    secs = time.perf_counter() - t
    torch.cuda.synchronize()
    return secs / reps * 1e6


def random_limbs(n: int, device, seed: int) -> torch.Tensor:
    """(16, n) canonical Fq elements drawn on the card: uniform 16-bit limbs,
    the top limb below the modulus's."""
    gen = torch.Generator(device=device).manual_seed(seed)
    limbs = torch.randint(0, 1 << 16, (16, n), generator=gen, device=device, dtype=torch.int32)
    limbs[15] = limbs[15] % (bn254.Q >> 240)
    return limbs


def device_profile(tag: str, fn) -> None:
    """Run fn() once under torch.profiler and log the card's share of it:
    wall time, device busy time (the sum of the kernels' durations on the
    one stream), kernel count, and the five kernels with the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        log(f"[{tag}] profiler: no device activity recorded; busy share not measured")
        return
    busy = sum(r[1] for r in rows) / 1e6
    log(f"[{tag}] profiler: wall {wall:.4f} s (profiled), device busy {busy:.4f} s = "
        f"{100 * busy / wall:.1f}%, {sum(r[2] for r in rows)} device kernels")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:5]:
        log(f"[{tag}]   {us / 1e3:9.3f} ms  {count:6d} x  {key[:90]}")


def bound(name: str, n: int, added: float = 1.0, mads_per_s: float = INT32_MADS_PER_S) -> dict:
    """The least time the card could take for one launch of `name` on n
    elements: the larger of bytes over the memory rate and multiply-adds
    over the integer rate.  `added`: under a mask, the share of elements
    that are added; the others move two thirds of the planes (one operand
    in, out again) and take no product."""
    nbytes, muls, sqrs = KERNEL_WORK[name]
    mads = muls * MADS_PER_MONT_MUL + sqrs * MADS_PER_MONT_SQR
    passed = (nbytes - 4) * 2 // 3 + 4  # the mask, one operand in, the output
    by_bytes = n * (added * nbytes + (1 - added) * passed) / HBM_BYTES_PER_S * 1e3
    by_ops = n * added * mads / mads_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None}  # no PyTorch call computes any of these functions


def timings(name: str, n: int, kernel, plain, plain_reps: int, big_n: int, big_kernel,
            added: float = 1.0) -> dict:
    """The three times of a kernel and its bounds: at the path's shape
    (kernel and plain version), the host's cost of a launch there, and the
    device time at the large batch with the bound at that batch."""
    big = bound(name, big_n, added)
    probed = bound(name, big_n, added, PROBED_MADS_PER_S["rate"])
    return {
        "shape": n, **bound(name, n, added),
        "ms": cuda_time_ms(kernel, 50),
        "plain_ms": cuda_time_ms(plain, plain_reps),
        "host_us_per_launch": host_us_per_launch(kernel),
        "device_batch": big_n,
        "device_ms": cuda_time_ms(big_kernel, 20),
        "device_bound_ms": big["bound_ms"],
        "device_bound_by": big["bound_by"],
        # the same bound with the multiply-add rate the probe measured
        "device_probed_bound_ms": probed["bound_ms"],
        "device_probed_bound_by": probed["bound_by"],
    }


def require_launches(path: str, launches: dict, names) -> None:
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {path} path")


def _check(result) -> None:
    if result.result_code != ProofResultCode.COMPLETED_OK:
        raise AssertionError(f"{type(result).__name__}: {result.error_message}")


class scratch_dir:
    """A fresh directory under the checkout's tmp/ (git ignores it), removed
    on exit: where the STARK wrap's CRS is made and read back."""

    def __enter__(self) -> str:
        import tempfile

        (ROOT / "tmp").mkdir(exist_ok=True)
        self.path = tempfile.mkdtemp(prefix="crs-", dir=ROOT / "tmp")
        return self.path

    def __exit__(self, *exc):
        import shutil

        shutil.rmtree(self.path, ignore_errors=True)
        return False


def drive(prover, blocks, step_launches: dict | None = None, aggregator: str = AGGREGATOR):
    """The four steps, in the order the node's state machine drives them;
    step 3 aggregates the first and last chunk proofs.  Every step is
    synchronised and timed; `step_launches`, where given, receives each
    step's own launch counts."""
    times = {}

    def run(step, fn):
        before = dict(kernels.LAUNCHES)
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        times[step] = time.perf_counter() - t
        if step_launches is not None:
            step_launches[step] = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
        _check(result)
        return result

    r1 = run("gen_batch_chunks", lambda: prover.gen_batch_chunks("smoke", blocks, CHAIN_ID, "evm"))
    r2 = run("gen_chunk_proof", lambda: prover.gen_chunk_proof(
        "smoke", r1.task_id, r1.chunk_count, CHAIN_ID, "evm", r1.batch_data))
    r3 = run("gen_aggregated_proof", lambda: prover.gen_aggregated_proof(
        "smoke", r2.chunk_proofs[0].proof, r2.chunk_proofs[-1].proof))
    r4 = run("gen_final_proof", lambda: prover.gen_final_proof(
        "smoke", r3.result_string, "BN128", aggregator))
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


def phase_build(device) -> None:
    t = time.perf_counter()
    kernels.build()
    log(f"[build] kernels built in {time.perf_counter() - t:.1f} s")
    for line in kernels.ptxas_report().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
    # the integer rate the bounds assume, beside the card's: 8 blocks of 256
    # threads per SM; the bare wide multiply-add, then chains of Montgomery
    # products (136 multiply-adds each)
    blocks = 8 * torch.cuda.get_device_properties(device).multi_processor_count
    for mode, what, iters in ((0, "mad.wide.u32 on 8 accumulators per thread", 1 << 16),
                              (1, "Montgomery products, 2 chains per thread", 1 << 11)):
        mads, _ = kernels.imad_probe(device, mode, blocks, iters=iters)
        ms = cuda_time_ms(lambda: kernels.imad_probe(device, mode, blocks, iters=iters), 3)
        log(f"[probe] {what}: {mads} multiply-adds in {ms:.3f} ms = "
            f"{mads / ms / 1e9:.3f} T multiply-adds/s measured; the bounds assume "
            f"{INT32_MADS_PER_S / 1e12:.3f} T/s")
        if mode == 0:
            PROBED_MADS_PER_S["rate"] = mads / ms * 1e3


def _random_fq(rng, n: int) -> list[int]:
    return [int.from_bytes(rng.bytes(32), "little") % bn254.Q for _ in range(n)]


def _compare(name: str, got, ref) -> int:
    """Bit-for-bit equality of two tuples of tensors; returns the max abs
    err (0) or raises."""
    err = max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref))
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError(f"{name} disagrees with its plain version (max abs err {err})")
    return err


def _leaves(point) -> tuple:
    """The limb planes of a G1 point (3) or a G2 point (6), in order."""
    return tuple(t for coord in point for t in (coord if isinstance(coord, tuple) else (coord,)))


def _masks(rng, n: int, device):
    """All set, none set, mixed (non-zero values other than 1 included)."""
    mixed = torch.tensor(rng.integers(0, 2, n), dtype=torch.int32, device=device) * 5
    return torch.ones_like(mixed), torch.zeros_like(mixed), mixed


def _check_masked(name, add, plain, ctx, p, q, masks) -> int:
    """The masked add against its plain version for every mask and both kept
    operands; a fully passed operand must come out limb for limb."""
    err = 0
    for keep in (0, 1):
        for mask in masks:
            got = add(ctx, p, q, mask, keep)
            err = max(err, _compare(f"{name} (keep = {keep})", _leaves(got),
                                    _leaves(plain(ctx, p, q, mask, keep))))
        got = add(ctx, p, q, masks[0], keep)
        if not all(torch.equal(g, k) for g, k in zip(_leaves(got), _leaves((p, q)[keep]))):
            raise AssertionError(f"{name}: an all-set mask did not pass operand {keep} through")
    return err


def phase_kernels(device) -> dict:
    """Each kernel against its plain version on the same inputs, bit for bit."""
    rng = np.random.default_rng(2024)
    ctx = bn254.fq()
    Q = bn254.Q
    results = {}

    va, vb = _random_fq(rng, KERNEL_BATCH), _random_fq(rng, KERNEL_BATCH)
    va[:4], vb[:4] = [0, 1, Q - 1, Q - 2], [Q - 1, Q - 1, Q - 1, 0]
    a, b = ctx.from_int(va, device), ctx.from_int(vb, device)
    err = _compare("mont_mul", (kernels.mont_mul(ctx, a, b),), (kernels.mont_mul_plain(ctx, a, b),))
    _phase_carry_edges(device)
    big_a, big_b = random_limbs(BIG_FIELD, device, 1), random_limbs(BIG_FIELD, device, 2)
    results["mont_mul"] = {
        "max_abs_err": err,
        **timings("mont_mul", KERNEL_BATCH, lambda: kernels.mont_mul(ctx, a, b),
                  lambda: kernels.mont_mul_plain(ctx, a, b), 10,
                  BIG_FIELD, lambda: kernels.mont_mul(ctx, big_a, big_b)),
    }
    del big_a, big_b

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
    err = _compare("point_add", got3, kernels.point_add_plain(ctx, p, q))
    # the edge cases mean what they should: affine results against host math
    ax, ay = bn254.to_affine(bn254.FqOps(), bn254.PointJ(*(t[:, : len(P)] for t in got3)))
    xs, ys = ctx.to_int(ax), ctx.to_int(ay)
    for i, (u, v) in enumerate(zip(P, Qp)):
        want = bn254.h_ec_add(u, v)
        have = None if (want is None and xs[i] == 0 and ys[i] == 0) else (int(xs[i]), int(ys[i]))
        if have != want:
            raise AssertionError(f"point_add edge case {i} is wrong")
    big_p = tuple(random_limbs(BIG_POINT, device, 10 + k) for k in range(3))
    big_q = tuple(random_limbs(BIG_POINT, device, 20 + k) for k in range(3))
    results["point_add"] = {
        "max_abs_err": err,
        **timings("point_add", KERNEL_BATCH, lambda: kernels.point_add(ctx, p, q),
                  lambda: kernels.point_add_plain(ctx, p, q), 5,
                  BIG_POINT, lambda: kernels.point_add(ctx, big_p, big_q)),
    }
    masks = _masks(rng, KERNEL_BATCH, device)
    big_mask = _masks(rng, BIG_POINT, device)[2]
    added = 1.0 - float((masks[2] != 0).float().mean())
    results["point_add_masked"] = {
        "max_abs_err": _check_masked("point_add", kernels.point_add, kernels.point_add_plain,
                                     ctx, p, q, masks),
        **timings("point_add_masked", KERNEL_BATCH,
                  lambda: kernels.point_add(ctx, p, q, masks[2], 1),
                  lambda: kernels.point_add_plain(ctx, p, q, masks[2], 1), 5,
                  BIG_POINT, lambda: kernels.point_add(ctx, big_p, big_q, big_mask, 1),
                  added=added),
    }
    del big_p, big_q
    results.update(_phase_step_kernels(device, rng))
    results["mont_pow"] = _phase_pow_kernel(device, rng)
    results.update(_phase_g2_kernel(device, rng))
    poseidon2 = _phase_poseidon_kernel(device, rng)
    for name, r in results.items():
        log(f"[kernels] {name}: bit-exact vs plain at (16, {r.pop('shape')}); "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}; host "
            f"{r['host_us_per_launch']:.1f} us per launch; device {r['device_ms']:.4f} ms at "
            f"(16, {r['device_batch']}), bound {r['device_bound_ms']:.4f} ms by "
            f"{r['device_bound_by']} ({r['device_probed_bound_ms']:.4f} ms by "
            f"{r['device_probed_bound_by']} at the probed multiply-add rate)")
    results["poseidon2"] = poseidon2
    results["poseidon_fr"] = _phase_poseidon_fr_kernel(device, rng)
    return results


def poseidon_bound(rows: int, k_in: int, k_out: int, perms_per_row: int,
                   mads_per_s: float = INT32_MADS_PER_S) -> dict:
    """The least time the card could take for one launch of kernel E over
    `rows` rows: k_in words read and k_out written per row against
    perms_per_row permutations of MADS_PER_PERM wide multiply-adds."""
    by_bytes = rows * (k_in + k_out) * 8 / HBM_BYTES_PER_S * 1e3
    by_ops = rows * perms_per_row * MADS_PER_PERM / mads_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _random_gl(rng, shape, device) -> torch.Tensor:
    return gl.from_int(rng.integers(0, gl.P, shape, dtype=np.uint64), device)


def _phase_poseidon_kernel(device, rng) -> dict:
    """Kernel E's four entry points against their plain versions, bit for
    bit, at the shapes the provers give them, with edge values, row lengths
    and tree nodes checked against the host sponge and compression too."""
    P = gl.P
    err = 0

    def same(what, got, ref) -> None:
        nonlocal err
        err = max(err, _compare(f"poseidon2 {what}", (got,), (ref,)))

    def entry(rows, k_in, k_out, perms, kernel, plain, plain_rows, reps):
        big = poseidon_bound(rows, k_in, k_out, perms)
        probed = poseidon_bound(rows, k_in, k_out, perms, PROBED_MADS_PER_S["rate"])
        return {"rows": rows, "ms": cuda_time_ms(kernel, reps), "plain_ms": cuda_time_ms(plain, 1, 1),
                "plain_rows": plain_rows, **big,
                "probed_bound_ms": probed["bound_ms"], "probed_bound_by": probed["bound_by"]}

    # perm: 2^18 states; the first rows aim at the lazy core's bounds: every
    # lane 0, 1, p - 1 (which drives each partial round's mu_i·s_i towards
    # its maximum), p - 2^32, 2^32 - 1, 2^32, then random mixes of those
    states = _random_gl(rng, (E_PERM_BATCH, 12), device)
    edge = [0, 1, P - 1, P - (1 << 32), (1 << 32) - 1, 1 << 32]
    edge_rows = [[v] * 12 for v in edge] + [list(rng.choice(edge, 12)) for _ in range(E_EDGE - 6)]
    states[:E_EDGE] = gl.from_int(np.asarray(edge_rows, dtype=np.uint64), device)
    same("perm", poseidon.perm(states), poseidon.perm_plain(states))
    for i in range(0, E_EDGE, 3):
        if [int(v) for v in gl.to_int(poseidon.perm(states[i]))] != poseidon.perm_host(
                [int(v) for v in gl.to_int(states[i])]):
            raise AssertionError(f"poseidon2 perm differs from the host permutation (state {i})")
    flat = states[:E_EDGE].reshape(-1, 24)  # the edge words through the sponge
    same("hash_rows on edge words", poseidon.hash_elements(flat), poseidon.hash_elements_plain(flat))
    entries = {"perm": entry(E_PERM_BATCH, 12, 12, 1, lambda: poseidon.perm(states),
                             lambda: poseidon.perm_plain(states), E_PERM_BATCH, 5)}

    # hash_rows, edge rows: every length from 0 to 17 and 216, values 0, p - 1, random
    for k in (*range(18), ATT_COLS):
        rows = _random_gl(rng, (5, k), device)
        rows[0], rows[1] = 0, gl.as_i64(P - 1)
        got = poseidon.hash_elements(rows)
        same(f"hash_rows (k = {k})", got, poseidon.hash_elements_plain(rows))
        for i in (0, 1, 4):
            if [int(v) for v in gl.to_int(got[i])] != poseidon.hash_elements_host(
                    [int(v) for v in gl.to_int(rows[i])]):
                raise AssertionError(f"poseidon2 hash_rows differs from the host sponge (k = {k})")
    if poseidon.hash_elements(gl.zeros((0, 9), device)).shape != (0, 4):
        raise AssertionError("poseidon2 hash_rows of no rows is not (0, 4)")

    # hash_rows at the attestation's shape: the (216, 2^21) column matrix read
    # as rows through its strides.  The plain version takes the first and the
    # last E_PLAIN_ROWS rows (every row in full; hashing all 2^21 rows the plain
    # way is some 500 million small launches' worth of device memory traffic)
    cols = _random_gl(rng, (ATT_COLS, ATT_ROWS), device)
    wide = cols.T
    got = poseidon.hash_elements(wide)
    torch.cuda.synchronize()
    head, tail = slice(0, E_PLAIN_ROWS), slice(ATT_ROWS - E_PLAIN_ROWS, ATT_ROWS)
    for part in (head, tail):
        same("hash_rows on wide rows", got[part], poseidon.hash_elements_plain(wide[part]))
    same("hash_rows on a row-major copy", poseidon.hash_elements(wide[head].contiguous()), got[head])
    entries["hash_rows"] = entry(
        ATT_ROWS, ATT_COLS, 4, ATT_COLS // 8, lambda: poseidon.hash_elements(wide),
        lambda: poseidon.hash_elements_plain(wide[head]), E_PLAIN_ROWS, 3)
    del cols, wide, got

    # hash_rows on FRI's first layer of the attestation, 2^20 (u, v) pairs;
    # the chunk STARKs' batched leaves (K, m, 2) take the same route
    pairs = _random_gl(rng, (ATT_ROWS // 2, 2), device)
    same("hash_rows on pairs", poseidon.hash_elements(pairs), poseidon.hash_elements_plain(pairs))
    batched = pairs[: 2 * 16384].reshape(2, 16384, 2)
    same("hash_rows on batched pairs", poseidon.hash_elements(batched),
         poseidon.hash_elements(pairs[: 2 * 16384]).reshape(2, 16384, 4))
    entries["hash_rows_pairs"] = entry(
        ATT_ROWS // 2, 2, 4, 1, lambda: poseidon.hash_elements(pairs),
        lambda: poseidon.hash_elements_plain(pairs), ATT_ROWS // 2, 5)

    # hash_two: a Merkle level, the even and odd digests of 2^21 read in place
    level = _random_gl(rng, (ATT_ROWS, 4), device)
    level[0], level[1], level[2], level[3] = 0, 0, gl.as_i64(P - 1), gl.as_i64(P - 1)
    left, right = level[0::2], level[1::2]
    got = poseidon.hash_two(left, right)
    same("hash_two", got, poseidon.hash_two_plain(left, right))
    for i in (0, 1, 2):
        want = poseidon.hash_two_host([int(v) for v in gl.to_int(left[i])],
                                      [int(v) for v in gl.to_int(right[i])])
        if [int(v) for v in gl.to_int(got[i])] != want:
            raise AssertionError("poseidon2 hash_two differs from the host compression")
    entries["hash_two"] = entry(ATT_ROWS // 2, 8, 4, 1, lambda: poseidon.hash_two(left, right),
                                lambda: poseidon.hash_two_plain(left, right), ATT_ROWS // 2, 5)
    small = level[:2048]
    host_us = host_us_per_launch(lambda: poseidon.hash_two(small[0::2], small[1::2]))

    # the tree entry: the attestation's 2^21-leaf trace tree in one launch,
    # each level against the plain version, nodes at the bottom, the middle
    # and the top against the host compression; a batch of K = 9 trees of
    # 2^14 leaves (the chunk STARKs' batched commit) against the plain version
    before = kernels.LAUNCHES["poseidon2"]
    tree = merkle.commit_digests(level)
    launched = kernels.LAUNCHES["poseidon2"] - before
    if launched != 1:
        raise AssertionError(f"a 2^21-leaf tree took {launched} launches of kernel E, expected 1")
    for depth, (got, ref) in enumerate(zip(tree[1:], poseidon.merkle_levels_plain(level)), 1):
        same(f"tree level {depth}", got, ref)
    top = ATT_ROWS.bit_length() - 1
    for depth, i in ((1, 0), (1, ATT_ROWS // 2 - 1), (top // 2, 1), (top, 0)):
        kids = [[int(v) for v in gl.to_int(tree[depth - 1][2 * i + c])] for c in (0, 1)]
        if [int(v) for v in gl.to_int(tree[depth][i])] != poseidon.hash_two_host(*kids):
            raise AssertionError(f"tree node {i} of level {depth} differs from the host compression")
    chunks = _random_gl(rng, (9, E_CHUNK_LEAVES, 4), device)
    for got, ref in zip(poseidon.merkle_levels(chunks), poseidon.merkle_levels_plain(chunks)):
        same("tree entry on 9 batched trees", got, ref)
    entries["tree"] = entry(ATT_ROWS - 1, 4, 4, 1, lambda: merkle.commit_digests(level),
                            lambda: poseidon.merkle_levels_plain(level), ATT_ROWS - 1, 5)
    log(f"[kernels] poseidon2 tree: {ATT_ROWS} leaves in {launched} launch, every level equal "
        f"to the plain version, nodes equal to the host compression; 9 batched trees of "
        f"{E_CHUNK_LEAVES} leaves equal to the plain version")

    for name, e in entries.items():
        log(f"[kernels] poseidon2 {name}: bit-exact vs plain; {e['rows']} rows: kernel "
            f"{e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms on {e['plain_rows']} rows, bound "
            f"{e['bound_ms']:.4f} ms by {e['bound_by']} ({e['probed_bound_ms']:.4f} ms by "
            f"{e['probed_bound_by']} at the probed multiply-add rate)")
    log(f"[kernels] poseidon2: host {host_us:.1f} us per launch (hash_two on 1,024 pairs)")
    # the kernel's row: the sponge over the attestation's wide rows, where the
    # recursion path spends its hashing; device_ms is that launch's own time
    main = entries["hash_rows"]
    return {
        "max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "plain_rows": main["plain_rows"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "host_us_per_launch": host_us, "device_batch": ATT_ROWS, "device_ms": main["ms"],
        "device_bound_ms": main["bound_ms"], "device_bound_by": main["bound_by"],
        "device_probed_bound_ms": main["probed_bound_ms"],
        "device_probed_bound_by": main["probed_bound_by"],
        "entries": entries,
    }


def poseidon_fr_bound(rows: int, k_in: int, k_out: int, perms_per_row: int,
                      mads_per_s: float = INT32_MADS_PER_S) -> dict:
    """The least time the card could take for one launch of kernel F over
    `rows` rows: k_in words read and k_out written per row against
    perms_per_row permutations of MADS_PER_PERM_FR multiply-adds."""
    by_bytes = rows * (k_in + k_out) * 8 / HBM_BYTES_PER_S * 1e3
    by_ops = rows * perms_per_row * MADS_PER_PERM_FR / mads_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _phase_poseidon_fr_kernel(device, rng) -> dict:
    """Kernel F's three entry points against their plain versions, bit for
    bit, at the shapes the wrap-profile attestation gives them, with edge
    states and nodes against the host permutation, sponge and compression.
    Times: `ms` at the path's shape, `device_ms` at a large batch."""
    from eigen_zeth_tpu_torch.ops import poseidon_fr as pfr

    R, P = pfr.R, gl.P
    err = 0

    def same(what, got, ref) -> None:
        nonlocal err
        err = max(err, _compare(f"poseidon_fr {what}", (got,), (ref,)))

    def fr_ints(n):
        return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]

    def timed_plain(fn):
        """(fn(), its time in ms): the plain version is timed on the call
        that checks the kernel (a call of it costs seconds of launches)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def entry(rows, k_in, k_out, perms, ms, plain_ms, plain_rows, big_rows, big_ms):
        out = {"rows": rows, "ms": ms, "plain_ms": plain_ms, "plain_rows": plain_rows,
               **poseidon_fr_bound(rows, k_in, k_out, perms),
               "device_rows": big_rows, "device_ms": big_ms}
        for tag, r in (("device_", big_rows), ("device_probed_", big_rows), ("probed_", rows)):
            rate = PROBED_MADS_PER_S["rate"] if "probed" in tag else INT32_MADS_PER_S
            b = poseidon_fr_bound(r, k_in, k_out, perms, rate)
            out[tag + "bound_ms"], out[tag + "bound_by"] = b["bound_ms"], b["bound_by"]
        return out

    # perm: the grind search's batch, with edge states: every lane 0, 1,
    # r - 1, 2^64 - 1, 2^192 - 1, and mixes of them
    edges = [0, 1, R - 1, (1 << 64) - 1, (1 << 192) - 1]
    states = [[e] * 12 for e in edges] + [list(rng.choice(np.array(edges, dtype=object), 12))
                                          for _ in range(27)]
    states += [fr_ints(12) for _ in range(F_GRIND_BATCH - len(states))]
    words = pfr.words_from_ints(states, device)
    got = pfr.perm_device(words)
    plain, perm_plain_ms = timed_plain(lambda: pfr.perm_fr_plain(words))
    same("perm", got, plain)
    for i in range(0, 32, 3):
        if pfr.ints_from_words(got[i]) != pfr.perm_host(states[i]):
            raise AssertionError(f"poseidon_fr perm differs from the host permutation (state {i})")
    big = pfr.words_from_ints([fr_ints(12) for _ in range(1024)], device).repeat(F_BIG_PERM // 1024, 1, 1)
    entries = {"perm": entry(F_GRIND_BATCH, 48, 48, 1,
                             cuda_time_ms(lambda: kernels.poseidon_fr_perm(words), 20),
                             perm_plain_ms, F_GRIND_BATCH,
                             F_BIG_PERM, cuda_time_ms(lambda: kernels.poseidon_fr_perm(big), 5))}
    host_us = host_us_per_launch(lambda: kernels.poseidon_fr_perm(words[:256]))
    del big

    # hash_rows, edge rows: lengths 1..13, 33, 34 and 216, values 0, p - 1, random
    for k in (*range(1, 14), 33, 34, ATT_COLS):
        rows = _random_gl(rng, (5, k), device)
        rows[0], rows[1] = 0, gl.as_i64(P - 1)
        got = kernels.poseidon_fr_hash_rows(rows)
        same(f"hash_rows (k = {k})", got, pfr.hash_rows_fr_plain(rows))
        for i in (0, 1, 4):
            row = [int(v) for v in gl.to_int(rows[i])]
            if pfr.ints_from_words(got[i])[0] != pfr.hash_elements_host(pfr.pack_gl_host(row)):
                raise AssertionError(f"poseidon_fr hash_rows differs from the host sponge (k = {k})")

    # hash_rows at the wrap attestation's shape: the (216, 2^23) LDE read as
    # rows through its strides; the plain version on the first F_PLAIN_ROWS
    # rows, the host sponge on rows at the far end
    gen = torch.Generator(device=device).manual_seed(7)
    cols = torch.randint(0, 1 << 62, (ATT_COLS, WRAP_ROWS), generator=gen, device=device)
    cols[:, :2] = gl.as_i64(P - 1)  # canonical words, the largest ones in the first rows
    wide = cols.T
    digests = kernels.poseidon_fr_hash_rows(wide)
    head = slice(0, F_PLAIN_ROWS)
    plain, rows_plain_ms = timed_plain(lambda: pfr.hash_rows_fr_plain(wide[head]))
    same("hash_rows on wide rows", digests[head], plain)
    last = [WRAP_ROWS - 1, WRAP_ROWS - F_PLAIN_ROWS]  # the far end, against the host sponge
    if pfr.ints_from_words(digests[last]) != [pfr.hash_elements_host(pfr.pack_gl_host(
            [int(v) for v in gl.to_int(wide[i])])) for i in last]:
        raise AssertionError("poseidon_fr hash_rows differs from the host sponge at the far end")
    wide_ms = cuda_time_ms(lambda: kernels.poseidon_fr_hash_rows(wide), 1)
    entries["hash_rows"] = entry(
        WRAP_ROWS, ATT_COLS, 4, WRAP_PERMS_PER_ROW, wide_ms,
        rows_plain_ms, F_PLAIN_ROWS,
        WRAP_ROWS, wide_ms)
    del cols, wide

    # merkle_levels: the trace tree over 2^23 leaf digests in one launch, every
    # level of a subtree of F_PLAIN_LEAVES leaves against the plain version,
    # nodes against the host compression
    before = kernels.LAUNCHES["poseidon_fr"]
    tree = kernels.poseidon_fr_merkle_levels(digests)
    if kernels.LAUNCHES["poseidon_fr"] - before != 1:
        raise AssertionError("a 2^23-leaf Fr tree took more than one launch of kernel F")
    small = digests[:F_PLAIN_LEAVES]
    plain, tree_plain_ms = timed_plain(lambda: pfr.merkle_levels_fr_plain(small))
    for depth, (got, ref) in enumerate(zip(kernels.poseidon_fr_merkle_levels(small), plain), 1):
        same(f"tree level {depth}", got, ref)
        if not torch.equal(got, tree[depth - 1][: got.shape[0]]):
            raise AssertionError(f"the 2^23-leaf tree's level {depth} differs from its subtree's")
    top = WRAP_ROWS.bit_length() - 1
    levels = [digests] + tree
    for depth, i in ((1, 0), (1, WRAP_ROWS // 2 - 1), (top // 2, 3), (top, 0)):
        kids = pfr.ints_from_words(levels[depth - 1][2 * i : 2 * i + 2])
        if pfr.ints_from_words(levels[depth][i : i + 1]) != [pfr.hash_two_host(*kids)]:
            raise AssertionError(f"Fr tree node {i} of level {depth} differs from the host")
    tree_ms = cuda_time_ms(lambda: kernels.poseidon_fr_merkle_levels(digests), 1)
    entries["merkle_levels"] = entry(
        WRAP_ROWS - 1, 4, 4, 1, tree_ms,
        tree_plain_ms, F_PLAIN_LEAVES - 1,
        WRAP_ROWS - 1, tree_ms)
    del digests, tree, levels

    for name, e in entries.items():
        log(f"[kernels] poseidon_fr {name}: bit-exact vs plain; {e['rows']} rows: kernel "
            f"{e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms on {e['plain_rows']} rows, bound "
            f"{e['bound_ms']:.4f} ms by {e['bound_by']} ({e['probed_bound_ms']:.4f} ms at the "
            f"probed rate); {e['device_rows']} rows: {e['device_ms']:.4f} ms, bound "
            f"{e['device_bound_ms']:.4f} ms ({e['device_probed_bound_ms']:.4f} ms probed)")
    log(f"[kernels] poseidon_fr: host {host_us:.1f} us per launch (perm on 256 states); "
        f"{MADS_PER_PERM_FR} multiply-adds a permutation")
    # the kernel's row: the leaf sponge over the wrap attestation's wide rows
    main = entries["hash_rows"]
    return {
        "max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "plain_rows": main["plain_rows"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "host_us_per_launch": host_us, "device_batch": WRAP_ROWS, "device_ms": main["device_ms"],
        "device_bound_ms": main["device_bound_ms"], "device_bound_by": main["device_bound_by"],
        "device_probed_bound_ms": main["device_probed_bound_ms"],
        "device_probed_bound_by": main["device_probed_bound_by"],
        "entries": entries,
    }


def _phase_carry_edges(device) -> None:
    """The field core on operands that stress its carry chains (words of all
    ones, q - 1, R mod q and their like), every pairing, for Fq and Fr:
    product against the plain version and against python ints, and the
    dedicated squaring (mont_pow with exponent 2) against the product."""
    words = [0, 1, 2, (1 << 256) - 1, (1 << 255) - 1, (1 << 224) - 1, 0xFFFFFFFF,
             0xFFFFFFFF << 224, 1 << 255, 1 << 128]
    for modulus in (bn254.Q, bn254.R):
        ctx = bn254.mont_ctx(modulus)
        vals = sorted({w % modulus for w in words}
                      | {modulus - 1, modulus - 2, ctx.R_mod, ctx.R2_mod, modulus >> 1})
        a = ctx.from_int([x for x in vals for _ in vals], device, mont=False)
        b = ctx.from_int([y for _ in vals for y in vals], device, mont=False)
        got = kernels.mont_mul(ctx, a, b)
        _compare("mont_mul on carry edges", (got,), (kernels.mont_mul_plain(ctx, a, b),))
        rinv = pow(ctx.R, -1, modulus)
        want = [x * y * rinv % modulus for x in vals for y in vals]
        if list(ctx.to_int(got, mont=False)) != want:
            raise AssertionError("mont_mul on carry edges differs from python ints")
        if not torch.equal(kernels.mont_pow(ctx, a, 2), kernels.mont_mul(ctx, a, a)):
            raise AssertionError("the squaring differs from the product on carry edges")
    log("[kernels] field core on carry-edge operands (Fq and Fr): product equals the plain "
        "version and python ints, squaring equals product")


def _phase_pow_kernel(device, rng) -> dict:
    """`mont_pow` against its plain version and python's pow, Fq and Fr, on
    0, 1, q - 1 and random values, exponents 0, 1, 2, q - 2 and random."""
    err = 0
    for modulus in (bn254.Q, bn254.R):
        ctx = bn254.mont_ctx(modulus)
        vals = [0, 1, modulus - 1] + [v % modulus for v in _random_fq(rng, POW_BATCH - 3)]
        a = ctx.from_int(vals, device)
        for e in (0, 1, 2, modulus - 2, int.from_bytes(rng.bytes(32), "little")):
            got = kernels.mont_pow(ctx, a, e)
            err = max(err, _compare(f"mont_pow (exponent {e})", (got,),
                                    (kernels.mont_pow_plain(ctx, a, e),)))
            if list(ctx.to_int(got)) != [pow(v, e, modulus) for v in vals]:
                raise AssertionError(f"mont_pow differs from python's pow (exponent {e})")
    ctx = bn254.fq()
    a = ctx.from_int(_random_fq(rng, POW_BATCH), device)
    big_a = random_limbs(BIG_POINT, device, 3)
    return {
        "max_abs_err": err,
        **timings("mont_pow", POW_BATCH, lambda: kernels.mont_pow(ctx, a, POW_EXPONENT),
                  lambda: kernels.mont_pow_plain(ctx, a, POW_EXPONENT), 1,
                  BIG_POINT, lambda: kernels.mont_pow(ctx, big_a, POW_EXPONENT)),
    }


def _phase_g2_kernel(device, rng) -> dict:
    """The G2 add, plain and masked, against its plain version, with the
    degenerate cases on real G2 points checked against host arithmetic."""
    ctx = bn254.fq()
    H2 = bn254.HOST_FQ2
    G2 = (bn254.G2_GEN_X, bn254.G2_GEN_Y)
    pts = [bn254.h_ec_mul(k, G2, H2) for k in range(1, 7)]
    P = pts + [pts[0], pts[1], None, pts[2], None]  # ..., P+P, P+(-P), inf+P, P+inf, inf+inf
    Qp = pts[::-1] + [pts[0], (pts[1][0], H2.neg(pts[1][1])), pts[3], None, None]
    n = G2_BATCH

    def coords(points):
        m = n - len(points)
        xy = [tuple(ctx.from_int([pt[c][j] if pt else 0 for pt in points] + _random_fq(rng, m),
                                 device) for j in range(2)) for c in range(2)]
        z0 = ctx.from_int([0 if pt is None else 1 for pt in points] + _random_fq(rng, m), device)
        z1 = ctx.from_int([0] * len(points) + _random_fq(rng, m), device)
        return (*xy, (z0, z1))

    p, q = coords(P), coords(Qp)
    got = kernels.point_add_g2(ctx, p, q)
    err = _compare("point_add_g2", _leaves(got), _leaves(kernels.point_add_g2_plain(ctx, p, q)))
    F2 = bn254.Fq2Ops()
    head = bn254.PointJ(*(tuple(t[:, : len(P)].contiguous() for t in c) for c in got))
    (x0, x1), (y0, y1) = (F2.to_int(c) for c in bn254.to_affine(F2, head))
    for i, (u, v) in enumerate(zip(P, Qp)):
        want = bn254.h_ec_add(u, v, H2) or ((0, 0), (0, 0))
        if ((int(x0[i]), int(x1[i])), (int(y0[i]), int(y1[i]))) != want:
            raise AssertionError(f"point_add_g2 edge case {i} is wrong")

    def big_point(seed):
        return tuple((random_limbs(BIG_POINT, device, seed + 2 * c),
                      random_limbs(BIG_POINT, device, seed + 2 * c + 1)) for c in range(3))

    big_p, big_q = big_point(30), big_point(40)
    out = {"point_add_g2": {
        "max_abs_err": err,
        **timings("point_add_g2", n, lambda: kernels.point_add_g2(ctx, p, q),
                  lambda: kernels.point_add_g2_plain(ctx, p, q), 3,
                  BIG_POINT, lambda: kernels.point_add_g2(ctx, big_p, big_q)),
    }}
    masks = _masks(rng, n, device)
    big_mask = _masks(rng, BIG_POINT, device)[2]
    added = 1.0 - float((masks[2] != 0).float().mean())
    out["point_add_g2_masked"] = {
        "max_abs_err": _check_masked("point_add_g2", kernels.point_add_g2,
                                     kernels.point_add_g2_plain, ctx, p, q, masks),
        **timings("point_add_g2_masked", n,
                  lambda: kernels.point_add_g2(ctx, p, q, masks[2], 0),
                  lambda: kernels.point_add_g2_plain(ctx, p, q, masks[2], 0), 3,
                  BIG_POINT, lambda: kernels.point_add_g2(ctx, big_p, big_q, big_mask, 0),
                  added=added),
    }
    return out


def _phase_step_kernels(device, rng) -> dict:
    """Kernels C and D at the fast MSM's step batch, against their plain
    versions and against each other."""
    ctx = bn254.fq()
    Q = bn254.Q
    n = STEP_BATCH
    pts = [bn254.h_ec_mul(k, bn254.G1_GEN) for k in range(1, 5)]
    neg = lambda p: (p[0], (-p[1]) % Q)  # noqa: E731
    P = pts[0]
    edge = [  # (accumulator, point, sign, flag, bad of C, bad of D)
        ((0, 0, 0), pts[1], 0, 1, 0, 1),        # all-zero accumulator under a flag
        ((0, 0, 0), pts[1], 1, 1, 0, 1),
        (P + (1,), P, 0, 0, 1, 1),              # P + P
        (P + (1,), neg(P), 0, 0, 1, 1),         # P + (-P)
        (P + (1,), P, 1, 0, 1, 1),              # the sign makes it P + (-P)
        (pts[2] + (0,), pts[3], 0, 0, 1, 1),    # accumulator at infinity
        (P + (1,), P, 0, 1, 0, 1),              # the same three under a flag
        (P + (1,), neg(P), 0, 1, 0, 1),
        (pts[2] + (0,), pts[3], 1, 1, 0, 1),
        (pts[2] + (1,), (pts[3][0], 0), 1, 0, 0, 0),  # y = 0 and sign set
        (pts[2] + (1,), (pts[3][0], 0), 1, 1, 0, 0),
        (pts[0] + (1,), pts[1], 0, 0, 0, 0),    # honest adds: G + 2G, G - 2G
        (pts[0] + (1,), pts[1], 1, 0, 0, 0),
    ]
    m = n - len(edge)
    cols = [[e[0][k] for e in edge] + _random_fq(rng, m) for k in range(3)]
    cols += [[e[1][k] for e in edge] + _random_fq(rng, m) for k in range(2)]
    ax, ay, az, bx, by = (ctx.from_int(c, device) for c in cols)
    sgn = torch.tensor([e[2] for e in edge] + rng.integers(0, 2, m).tolist(),
                       dtype=torch.int32, device=device)
    flg = torch.tensor([e[3] for e in edge] + rng.integers(0, 2, m).tolist(),
                       dtype=torch.int32, device=device)
    acc, q_aff = (ax, ay, az), (bx, by)

    got_c = kernels.point_scan_step(ctx, acc, q_aff, sgn, flg)
    err_c = _compare("point_scan_step", got_c,
                     kernels.point_scan_step_plain(ctx, acc, q_aff, sgn, flg))
    got_d = kernels.point_madd(ctx, acc, q_aff)
    err_d = _compare("point_madd", got_d, kernels.point_madd_plain(ctx, acc, q_aff))
    torch.cuda.synchronize()

    # the edge cases mean what they should
    k = len(edge)
    if got_c[3][:k].tolist() != [e[4] for e in edge] or got_d[3][:k].tolist() != [e[5] for e in edge]:
        raise AssertionError("bad planes of the edge cases are wrong")
    one = ctx.one_mont((1,), device)[:, 0]
    if not (torch.equal(got_c[2][:, 0], one) and int(got_c[1][:, 10].abs().sum()) == 0):
        raise AssertionError("restart under a flag, or -0 = 0, is wrong")
    F = bn254.FqOps()
    hx, hy = bn254.to_affine(F, bn254.PointJ(*(t[:, 11:13].contiguous() for t in got_c[:3])))
    have = list(zip(map(int, ctx.to_int(hx)), map(int, ctx.to_int(hy))))
    if have != [bn254.h_ec_add(pts[0], pts[1]), bn254.h_ec_add(pts[0], neg(pts[1]))]:
        raise AssertionError("the scan step's honest adds are not the curve's")

    # kernel C == sign select, then kernel D, then the restart select
    negate, restart = sgn != 0, flg != 0
    qy2 = torch.where(negate, ctx.neg(by), by)
    dx, dy, dz, dbad = kernels.point_madd(ctx, acc, (bx, qy2))
    composed = (torch.where(restart, bx, dx), torch.where(restart, qy2, dy),
                torch.where(restart, one[:, None], dz), dbad * (1 - flg))
    if not all(torch.equal(g, r) for g, r in zip(got_c, composed)):
        raise AssertionError("kernel C differs from select, kernel D, restart")
    log(f"[kernels] point_scan_step == sign select + point_madd + restart select at (16, {n})")

    big = tuple(random_limbs(BIG_POINT, device, 50 + k) for k in range(5))
    big_sgn, big_flg = (_masks(rng, BIG_POINT, device)[2] for _ in range(2))
    return {
        "point_scan_step": {
            "max_abs_err": err_c,
            **timings("point_scan_step", n,
                      lambda: kernels.point_scan_step(ctx, acc, q_aff, sgn, flg),
                      lambda: kernels.point_scan_step_plain(ctx, acc, q_aff, sgn, flg), 5,
                      BIG_POINT,
                      lambda: kernels.point_scan_step(ctx, big[:3], big[3:], big_sgn, big_flg)),
        },
        "point_madd": {
            "max_abs_err": err_d,
            **timings("point_madd", n, lambda: kernels.point_madd(ctx, acc, q_aff),
                      lambda: kernels.point_madd_plain(ctx, acc, q_aff), 5,
                      BIG_POINT, lambda: kernels.point_madd(ctx, big[:3], big[3:])),
        },
    }


def _sha(s: str) -> str:
    return hashlib.sha256(s.encode()).hexdigest()


def phase_golden(device) -> None:
    """The two tiny configurations of the golden file on the card: recursion
    off, and the recursion tier (two attestation STARKs in step 3)."""
    golden = json.loads(GOLDEN.read_text())
    for name, entry in (("recursion off", golden), ("recursion on", golden["recursion"])):
        cfg = entry["config"]
        prover = ps.BatchProver(
            stark_params=stark.StarkParams(**cfg["stark_params"]),
            wrap=cfg["wrap"],
            recursion=cfg["recursion"],
            chunk_trace_rows=cfg["chunk_trace_rows"],
            agg_queries=cfg.get("agg_queries", 30),
            groth16_seed=cfg["groth16_seed"],
            device=device,
        )
        t = time.perf_counter()
        prover.verifying_key  # the deterministic MiMC CRS, once per process
        log(f"[golden] Groth16 CRS setup (MiMC wrap): {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        _, r2, r3, r4, _ = drive(prover, cfg["blocks"])
        got = {
            "chunk_proofs": [_sha(c.proof) for c in r2.chunk_proofs],
            "aggregated": _sha(r3.result_string),
            "final_proof": _sha(r4.final_proof.proof),
            "public_input": _sha(r4.final_proof.public_input),
        }
        if got != entry["sha256"]:
            raise AssertionError(f"golden mismatch ({name}): {got} != {entry['sha256']}")
        log(f"[golden] tiny configuration, {name}, on the card in {time.perf_counter() - t:.2f} s: "
            "all sha256 digests match")
    phase_golden_stark_wrap(device)


def stark_wrap_prover(cfg: dict, crs_dir: str, device) -> ps.BatchProver:
    return ps.BatchProver(
        stark_params=stark.StarkParams(**cfg["stark_params"]),
        chunk_trace_rows=cfg["chunk_trace_rows"], agg_queries=cfg["agg_queries"], wrap="stark",
        wrap_queries=cfg["wrap_queries"], wrap_grind_bits=cfg["wrap_grind_bits"],
        wrap_blowup=cfg["wrap_blowup"], max_wrap_leaves=cfg["max_wrap_leaves"],
        groth16_seed=cfg["groth16_seed"], crs_dir=crs_dir, device=device,
    )


def phase_golden_stark_wrap(device) -> None:
    """The tiny stark-wrap configuration of tests/data/torch_stark_wrap_golden.json
    on the card: its CRS made into a fresh directory, the four steps, every
    sha256 digest the JAX package's."""
    golden = json.loads(STARK_GOLDEN.read_text())
    cfg = golden["config"]
    with scratch_dir() as crs_dir:
        prover = stark_wrap_prover(cfg, crs_dir, device)
        t = time.perf_counter()
        prover.ensure_wrap_crs(cfg["aggregator_addr"])
        t_crs = time.perf_counter() - t
        _, r2, r3, r4, times = drive(prover, cfg["blocks"], aggregator=cfg["aggregator_addr"])
    got = {
        "chunk_proofs": [_sha(c.proof) for c in r2.chunk_proofs],
        "aggregated": _sha(r3.result_string),
        "final_proof": _sha(r4.final_proof.proof),
        "public_input": _sha(r4.final_proof.public_input),
    }
    if got != golden["sha256"]:
        raise AssertionError(f"golden mismatch (stark wrap): {got} != {golden['sha256']}")
    log(f"[golden] tiny configuration, stark wrap, on the card: CRS {t_crs:.2f} s, four steps "
        f"{sum(times.values()):.2f} s: all sha256 digests match")


def require_at_most(path: str, launches: dict, name: str, most: int) -> None:
    if launches[name] > most:
        raise AssertionError(f"{launches[name]} launches of {name} on the {path} path, "
                             f"expected at most {most}")


# step 4's parts under the mimc wrap: the proof, each MSM inside it, verify
STEP4_PARTS = ((msm, "msm_g1"), (msm, "msm_g2"), (groth16, "prove"), (groth16, "verify"))


def phase_slice(device) -> dict:
    prover = ps.BatchProver(wrap="mimc", recursion=False, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    steps = {}
    kernels.reset_launches()
    with timed_funcs(STEP4_PARTS) as calls:
        r1, r2, r3, r4, times = drive(prover, list(range(1, SLICE_BLOCKS + 1)), steps)
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
    require_launches("batch proof", launches,
                     ("mont_mul", "mont_pow", "point_add", "point_add_masked", "point_add_g2",
                      "point_add_g2_masked", "poseidon2"))
    require_launches("batch proof, step 2", steps["gen_chunk_proof"], ("poseidon2",))
    require_at_most("batch proof", launches, "mont_mul", 200)
    if [name for name, _, _ in calls.times].count("msm_g2") != 1:
        raise AssertionError(f"expected one G2 MSM in the batch proof, got {calls.times}")

    log(f"[slice] {SLICE_BLOCKS} blocks, {r1.chunk_count} chunks of 4096 rows, mimc wrap")
    for step, s in times.items():
        log(f"[slice] {step}: {s:.3f} s")
    for name, n_points, s in calls.times:
        what = f"{name} of {n_points} points" if n_points else f"groth16.{name}, the whole call"
        log(f"[slice] gen_final_proof: {what}: {s:.3f} s")
    log(f"[slice] the G1 MSMs together: "
        f"{sum(s for name, _, s in calls.times if name == 'msm_g1'):.3f} s")
    log(f"[slice] total of the four steps: {sum(times.values()):.3f} s")
    log(f"[slice] max_memory_allocated: {peak / 2**20:.1f} MiB")
    log(f"[slice] launches: {launches}")
    log("[slice] 9/9 chunk proofs pass verify_chunk; the final proof passes groth16.verify")
    device_profile("slice step 2", lambda: prover.gen_chunk_proof(
        "smoke", r1.task_id, r1.chunk_count, CHAIN_ID, "evm", r1.batch_data))
    return launches


def phase_recursion(device) -> dict:
    """The batch proof as a node runs it: recursive aggregation on, the MiMC
    wrap, at the production chunk shape, through the four entry points."""
    prover = ps.BatchProver(recursion=True, wrap="mimc", device=device)
    sp = prover.stark_params
    shape = (prover.chunk_trace_rows, sp.blowup, sp.num_queries, sp.terminal_size,
             prover.agg_queries)
    if shape != (4096, 4, 32, 64, 30):
        raise AssertionError(f"not the production chunk shape: {shape}")

    # step 3 by stage: every stage of every attestation, synchronised
    stages, last = [], [0.0]

    def on_stage(name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages.append((name, now - last[0], torch.cuda.max_memory_allocated(device)))
        last[0] = now

    attest_chunk = recursion.attest_chunk

    def attest_from_now(*args, **kwargs):
        torch.cuda.synchronize()
        last[0] = time.perf_counter()  # the trace build starts here
        return attest_chunk(*args, **kwargs)

    steps = {}
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    air.STAGE_HOOK, recursion.attest_chunk = on_stage, attest_from_now
    try:
        with timed_funcs(STEP4_PARTS) as calls:
            r1, r2, r3, r4, times = drive(prover, list(range(1, RECURSION_BLOCKS + 1)), steps)
    finally:
        air.STAGE_HOOK, recursion.attest_chunk = None, attest_chunk
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)

    if r1.chunk_count != 2 or len(r2.chunk_proofs) != 2:
        raise AssertionError(f"expected 2 chunks, got {r1.chunk_count}")
    chunks = [json.loads(c.proof)["stark"] for c in r2.chunk_proofs]
    for i, proof in enumerate(chunks):
        if proof["n"] != 4096 or len(proof["fri"]["roots"]) != 8:
            raise AssertionError(f"chunk proof {i} has not the production shape")
        if not stark.verify_chunk(proof, sp):
            raise AssertionError(f"chunk proof {i} does not verify")
    agg = json.loads(r3.result_string)
    if [k["type"] for k in agg["children"]] != ["chunk-attested"] * 2:
        raise AssertionError("step 3 did not replace the chunk children by attestations")
    t = time.perf_counter()
    digests = []
    for i, att in enumerate(agg["children"]):
        p = att["air_proof"]
        if (p["n"], p["n_cols"], p["ext_blowup"], p["num_queries"]) != (1 << 18, ATT_COLS, 8, 30):
            raise AssertionError(f"attestation {i} has not the production shape")
        # raises ValueError where the verifier AIR's proof is rejected
        digest = recursion.verify_attestation(att, expected_queries=32, expected_rows=4096,
                                              expected_terminal=64)
        if digest != ps.chunk_digest(chunks[i]):
            raise AssertionError(f"attestation {i} does not bind its chunk's digest")
        digests.append(digest)
    t_verify = time.perf_counter() - t
    if [str(x) for x in poseidon.hash_two_host(*digests)] != agg["digest"]:
        raise AssertionError("the aggregated digest is not the hash of its children's")
    pub = [int(x) for x in json.loads(r4.final_proof.public_input)]
    if not groth16.verify(prover.verifying_key, json.loads(r4.final_proof.proof), pub):
        raise AssertionError("the final Groth16 proof does not verify")
    for step in ("gen_chunk_proof", "gen_aggregated_proof"):
        require_launches(f"recursion, {step}", steps[step], ("poseidon2",))
    per_attestation = steps["gen_aggregated_proof"]["poseidon2"] / len(agg["children"])
    if per_attestation > E_ATTESTATION_MOST:
        raise AssertionError(f"{per_attestation} launches of kernel E per attestation, "
                             f"expected at most {E_ATTESTATION_MOST}")
    require_launches("recursion", launches,
                     ("mont_mul", "mont_pow", "point_add", "point_add_masked", "point_add_g2",
                      "point_add_g2_masked", "poseidon2"))

    log(f"[recursion] {RECURSION_BLOCKS} blocks, {r1.chunk_count} chunks of 4096 rows "
        f"(blowup {sp.blowup}, {sp.num_queries} queries, terminal {sp.terminal_size}), "
        f"{prover.agg_queries} queries of the attestation STARK, mimc wrap")
    for step, s in times.items():
        log(f"[recursion] {step}: {s:.3f} s, poseidon2 launches {steps[step]['poseidon2']}")
    log(f"[recursion] kernel E launches per attestation: {per_attestation:g}")
    k = 0
    for name, s, mem in stages:
        k += name == "trace"
        log(f"[recursion] gen_aggregated_proof, attestation {k}: {name}: {s:.3f} s "
            f"(peak so far {mem / 2**20:.0f} MiB)")
    for name, n_points, s in calls.times:
        what = f"{name} of {n_points} points" if n_points else f"groth16.{name}, the whole call"
        log(f"[recursion] gen_final_proof: {what}: {s:.3f} s")
    log(f"[recursion] total of the four steps: {sum(times.values()):.3f} s")
    log(f"[recursion] max_memory_allocated: {peak / 2**20:.1f} MiB")
    log(f"[recursion] launches: {launches}")
    log(f"[recursion] 2/2 chunk proofs pass verify_chunk; 2/2 attestations (2^18 rows x "
        f"{ATT_COLS} columns, LDE 2^21) pass verify_attestation under the pinned shape "
        f"({t_verify:.3f} s on the host); the aggregated digest is their hash; the final "
        "proof passes groth16.verify")
    # where one attestation's time goes on the card (launch counts were read above)
    device_profile("recursion attestation", lambda: recursion.attest_chunk(
        chunks[0], num_queries_agg=prover.agg_queries, device=device))
    return launches


class timed_funcs:
    """While active, every call of the given module functions is
    synchronised and its wall time kept as (name, length of the first
    argument if it is a list else 0, seconds), in call order."""

    def __init__(self, targets):
        self.targets = targets
        self.times = []

    def __enter__(self):
        self._saved = [getattr(mod, name) for mod, name in self.targets]
        for (mod, name), fn in zip(self.targets, self._saved):
            setattr(mod, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            size = len(args[0]) if args and isinstance(args[0], list) else 0
            self.times.append((name, size, time.perf_counter() - t))
            return out
        return run

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.targets, self._saved):
            setattr(mod, name, fn)
        return False

    def total(self, name: str) -> float:
        return sum(s for n, _, s in self.times if n == name)


def phase_stark_wrap(device) -> dict:
    """The node's default, sound final wrap at the node's configuration:
    `BatchProver(recursion=True, wrap="stark")` with the production chunk
    shape and the default wrap profile (11 queries, 12 grinding bits, blowup
    32, two leaves), 1,600 blocks (2 chunks).  The CRS is made first, as a
    deployment does once (`ensure_wrap_crs`, into a fresh directory), then
    the four steps run as a node drives them."""
    from eigen_zeth_tpu_torch.models import crs, wrap_circuit

    with scratch_dir() as crs_dir:
        prover = ps.BatchProver(recursion=True, wrap="stark", crs_dir=crs_dir, device=device)
        sp = prover.stark_params
        shape = (prover.chunk_trace_rows, sp.blowup, sp.num_queries, sp.terminal_size,
                 prover.wrap_queries, prover.wrap_grind_bits, prover.wrap_blowup,
                 prover.max_wrap_leaves)
        if shape != (4096, 4, 32, 64, 11, 12, 32, 2):
            raise AssertionError(f"not the node's configuration: {shape}")

        stages, last = [], [0.0]

        def on_stage(name: str) -> None:
            torch.cuda.synchronize()
            now = time.perf_counter()
            stages.append((name, now - last[0], torch.cuda.max_memory_allocated(device)))
            last[0] = now

        attest = recursion.attest_chunk_wrap

        def attest_from_now(*args, **kwargs):
            torch.cuda.synchronize()
            last[0] = time.perf_counter()  # the trace build starts here
            return attest(*args, **kwargs)

        sizes = []
        build = wrap_circuit.build_final_circuit

        def build_counted(*args, **kwargs):
            out = build(*args, **kwargs)
            sizes.append((len(out[0].constraints), out[0].num_vars))
            return out

        targets = ((stark, "prove_chunk"), (wrap_circuit, "build_final_circuit"),
                   (crs, "generate"), (groth16, "_lagrange_at"), (groth16, "fixed_base_device"),
                   (crs, "save"), (crs, "load"), (groth16, "_row_values"),
                   (groth16, "_h_from_values_device"), (msm, "msm_affine"), (groth16, "prove"),
                   (groth16, "verify"))
        torch.cuda.reset_peak_memory_stats(device)
        air.STAGE_HOOK, recursion.attest_chunk_wrap = on_stage, attest_from_now
        wrap_circuit.build_final_circuit = build_counted
        try:
            with timed_funcs(targets) as crs_calls:
                kernels.reset_launches()
                t = time.perf_counter()
                prover.ensure_wrap_crs(AGGREGATOR)
                torch.cuda.synchronize()
                t_crs = time.perf_counter() - t
                crs_launches = dict(kernels.LAUNCHES)
            crs_stages = list(stages)
            stages.clear()
            crs_peak = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            prover._stark_crs.clear()  # step 4 loads the CRS from its files, as a node does
            steps = {}
            with timed_funcs(targets) as calls:
                kernels.reset_launches()
                r1, r2, r3, r4, times = drive(prover, list(range(1, STARK_WRAP_BLOCKS + 1)), steps)
            launches = dict(kernels.LAUNCHES)
        finally:
            air.STAGE_HOOK, recursion.attest_chunk_wrap = None, attest
            wrap_circuit.build_final_circuit = build
        peak = torch.cuda.max_memory_allocated(device)

        # gates
        if r1.chunk_count != 2 or len(r2.chunk_proofs) != 2:
            raise AssertionError(f"expected 2 chunks, got {r1.chunk_count}")
        chunks = [json.loads(c.proof)["stark"] for c in r2.chunk_proofs]
        for i, proof in enumerate(chunks):
            if proof["n"] != 4096 or not stark.verify_chunk(proof, sp):
                raise AssertionError(f"chunk proof {i} does not verify")
        agg = json.loads(r3.result_string)
        if [k["type"] for k in agg["children"]] != ["chunk-attested-wrap"] * 2:
            raise AssertionError("step 3 did not make wrap-profile attestations")
        t = time.perf_counter()
        stmts = []
        for i, att in enumerate(agg["children"]):
            p = att["wrap_proof"]
            if (p["n"], p["n_cols"], p["ext_blowup"], p["num_queries"], p["grind_bits"]) != (
                    1 << 18, ATT_COLS, 32, 11, 12):
                raise AssertionError(f"wrap attestation {i} has not the node's profile")
            digest = recursion.verify_attestation_wrap(
                att, expected_queries=32, expected_rows=4096, expected_terminal=64,
                expected_wrap_queries=11, expected_wrap_grind=12, wrap_blowup=32, device=device)
            if digest != ps.chunk_digest(chunks[i]):
                raise AssertionError(f"wrap attestation {i} does not bind its chunk's digest")
            a, publics, bnds = recursion.wrap_attestation_instance(
                att, expected_queries=32, expected_rows=4096, expected_terminal=64,
                wrap_blowup=32)
            stmts.append(wrap_circuit.statement_hash(a, publics, bnds, int(p["shift"]), 11, 12,
                                                      device=device))
        t_verify = time.perf_counter() - t
        pub = [int(x) for x in json.loads(r4.final_proof.public_input)]
        if pub != [wrap_circuit.final_public_input(stmts, AGGREGATOR)]:
            raise AssertionError("the public input is not the statement hash of the headers")
        vk = prover.pinned_vk(AGGREGATOR)
        proof = json.loads(r4.final_proof.proof)
        t = time.perf_counter()
        if not groth16.verify(vk, proof, pub):
            raise AssertionError("the final proof does not verify under the pinned VK")
        t_pinned = time.perf_counter() - t
        forged = dict(proof, pi_c=dict(proof["pi_a"]))
        if groth16.verify(vk, forged, pub):
            raise AssertionError("a forged pi_c passes groth16.verify")
        bad = json.loads(r3.result_string)
        row = bad["children"][0]["wrap_proof"]["trace_openings"][0][0]["row"]
        row[0] = str((int(row[0]) + 1) % gl.P)
        res = prover.gen_final_proof("smoke", json.dumps(bad), "BN128", AGGREGATOR)
        if res.result_code != ProofResultCode.COMPLETED_ERROR:
            raise AssertionError("a corrupted wrap attestation did not give COMPLETED_ERROR")
    for step in ("gen_chunk_proof",):
        require_launches(f"stark wrap, {step}", steps[step], ("poseidon2",))
    require_launches("stark wrap, gen_aggregated_proof", steps["gen_aggregated_proof"],
                     ("poseidon_fr",))
    require_at_most("stark wrap, gen_aggregated_proof", steps["gen_aggregated_proof"],
                    "poseidon_fr", F_STEP3_MOST)
    require_launches("stark wrap, gen_final_proof", steps["gen_final_proof"],
                     ("mont_mul", "mont_pow", "point_add", "point_add_masked", "point_add_g2",
                      "point_add_g2_masked"))
    require_launches("stark wrap, ensure_wrap_crs", crs_launches, ("point_add", "point_add_g2"))

    # the device fixed-base against the host one on 2^14 scalars (G1) and 2^10 (G2)
    rng = np.random.default_rng(77)
    for g2, n in ((False, 1 << 14), (True, 1 << 10)):
        scalars = [int.from_bytes(rng.bytes(32), "little") % bn254.R for _ in range(n)]
        scalars[1] = 0
        if groth16.fixed_base_device(scalars, g2, device).to_host() != groth16._host_fixed_base(
                scalars, g2):
            raise AssertionError(f"the device fixed-base differs from the host's ({n} scalars)")

    log(f"[stark-wrap] {STARK_WRAP_BLOCKS} blocks, {r1.chunk_count} chunks of 4096 rows "
        f"(blowup 4, 32 queries, terminal 64); wrap profile 11 queries, 12 grinding bits, "
        f"blowup 32, {prover.max_wrap_leaves} leaves")
    log(f"[stark-wrap] ensure_wrap_crs: {t_crs:.3f} s, peak {crs_peak / 2**20:.0f} MiB, "
        f"launches {crs_launches}")
    for name, secs, mem in crs_stages:
        log(f"[stark-wrap] ensure_wrap_crs, padding attestation: {name}: {secs:.3f} s "
            f"(peak so far {mem / 2**20:.0f} MiB)")
    for name, _, secs in crs_calls.times:
        if name not in ("fixed_base_device",):
            log(f"[stark-wrap] ensure_wrap_crs: {name}: {secs:.3f} s")
    log(f"[stark-wrap] ensure_wrap_crs: fixed_base_device x "
        f"{sum(1 for n, _, _ in crs_calls.times if n == 'fixed_base_device')}: "
        f"{crs_calls.total('fixed_base_device'):.3f} s")
    log(f"[stark-wrap] circuit: {sizes[0][0]} constraints, {sizes[0][1]} variables")
    for step, secs in times.items():
        log(f"[stark-wrap] {step}: {secs:.3f} s, launches F {steps[step]['poseidon_fr']}, "
            f"E {steps[step]['poseidon2']}, B {steps[step]['point_add']}, "
            f"B G2 {steps[step]['point_add_g2']}, A {steps[step]['mont_mul']}")
    k = 0
    for name, secs, mem in stages:
        k += name == "trace"
        log(f"[stark-wrap] gen_aggregated_proof, attestation {k}: {name}: {secs:.3f} s "
            f"(peak so far {mem / 2**20:.0f} MiB)")
    for name, _, secs in calls.times:
        if name != "prove_chunk":
            log(f"[stark-wrap] gen_final_proof: {name}: {secs:.3f} s")
    log(f"[stark-wrap] total of the four steps: {sum(times.values()):.3f} s")
    log(f"[stark-wrap] max_memory_allocated: {peak / 2**20:.1f} MiB (steps), "
        f"{crs_peak / 2**20:.1f} MiB (CRS)")
    log(f"[stark-wrap] launches: {launches}")
    log(f"[stark-wrap] 2/2 chunk proofs pass verify_chunk; 2/2 wrap attestations pass "
        f"verify_attestation_wrap under the pinned profile ({t_verify:.3f} s); the public input "
        f"is the statement hash of the headers; groth16.verify under the pinned VK is True "
        f"({t_pinned:.3f} s); a forged pi_c is rejected; a corrupted attestation gives "
        f"COMPLETED_ERROR; the device fixed-base equals the host's on 2^14 G1 and 2^10 G2 "
        f"scalars")
    return launches


def _host_eval(coeffs, z: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % bn254.R
    return acc


def test_points(device):
    """2^18 distinct G1 points on the card with their discrete logs."""
    t = time.perf_counter()
    xs, ys, dlogs = msm.gen_test_points(MSM_LOG2, device=device)
    torch.cuda.synchronize()
    log(f"[msm] gen_test_points({MSM_LOG2}) (host scalar multiplications + one device combine): "
        f"{time.perf_counter() - t:.3f} s")
    return xs, ys, dlogs


def phase_msm(device, points) -> dict:
    """The fast G1 MSM at 2^18 points through `msm.msm_g1_device`."""
    n = 1 << MSM_LOG2
    rng = np.random.default_rng(18)
    xs, ys, dlogs = points
    scalars = [int.from_bytes(rng.bytes(32), "little") % bn254.R for _ in range(n)]
    t = time.perf_counter()
    want = bn254.h_ec_mul_jac_f(sum(s * k for s, k in zip(scalars, dlogs)) % bn254.R, bn254.G1_GEN)
    t_oracle = time.perf_counter() - t
    inf = torch.zeros(n, dtype=torch.bool, device=device)
    limbs = msm._limbs_tensor(scalars, device)

    # the inner function shows `bad`; its first call also warms the card up
    windows = lambda: msm._msm_g1_fast_windows(  # noqa: E731
        xs, ys, inf, limbs, MSM_C, MSM_SERIAL, MSM_GROUP)
    *_, bad = windows()
    if bool(bad):
        raise AssertionError("the fast MSM raised `bad` on distinct points")
    torch.cuda.synchronize()
    t = time.perf_counter()
    windows()
    torch.cuda.synchronize()
    t_device = time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t = time.perf_counter()
    got = msm.msm_g1_device(xs, ys, inf, scalars, c=MSM_C, serial=MSM_SERIAL,
                            window_group=MSM_GROUP)
    torch.cuda.synchronize()
    t_entry = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)
    if got != want:
        raise AssertionError("the 2^18 MSM differs from the host oracle")
    if launches["point_scan_step"] != MSM_SERIAL:
        raise AssertionError(f"kernel C launched {launches['point_scan_step']} times, "
                             f"expected {MSM_SERIAL}")
    require_launches("fast MSM", launches,
                     ("mont_mul", "mont_pow", "point_add", "point_add_masked", "point_scan_step"))
    require_at_most("fast MSM", launches, "mont_mul", 16)

    log(f"[msm] 2^{MSM_LOG2} points, c = {MSM_C}, serial {MSM_SERIAL}, window group {MSM_GROUP}: "
        "bad = False, result equals the host oracle")
    log(f"[msm] host oracle (one scalar multiplication of G by Σ s_i·k_i): {t_oracle:.3f} s")
    log(f"[msm] device part alone (digits to affine window sums, synchronised): "
        f"{t_device:.4f} s = {n / t_device:.0f} points/s")
    log(f"[msm] msm_g1_device end to end (host scalar limbs and Horner included): "
        f"{t_entry:.4f} s = {n / t_entry:.0f} points/s")
    log(f"[msm] max_memory_allocated: {peak / 2**20:.1f} MiB")
    log(f"[msm] launches: {launches}")
    device_profile("msm", windows)

    # a duplicated point under one scalar: `bad` rises, the result stands
    m = 64
    small = msm.host_points(bn254.FqOps(), xs[:, :m], ys[:, :m], inf[:m])
    small[9] = small[8]
    sc = scalars[:m]
    sc[9] = sc[8]
    sx, sy, sinf = (t[..., :m].contiguous().clone() for t in (xs, ys, inf))
    sx[:, 9], sy[:, 9] = sx[:, 8], sy[:, 8]
    *_, bad = msm._msm_g1_fast_windows(sx, sy, sinf, msm._limbs_tensor(sc, device), 8, 32, 32)
    if not bool(bad):
        raise AssertionError("a duplicated point did not raise `bad`")
    oracle = None
    for pt, k in zip(small, sc):
        oracle = bn254.h_ec_add(oracle, bn254.h_ec_mul_jac_f(k, pt))
    if msm.msm_g1_device(sx, sy, sinf, sc, c=8) != oracle:
        raise AssertionError("the collision fallback differs from the host oracle")
    log(f"[msm] {m} points with one duplicated: bad = True, the complete-add schedule "
        "recomputes, result equals the host's")
    return launches


def phase_kzg(device) -> dict:
    """KZG at one blob's size: SRS on the card, commit, open, verify."""
    rng = np.random.default_rng(4844)
    draw = lambda k: [int.from_bytes(rng.bytes(32), "little") % bn254.R for _ in range(k)]  # noqa: E731
    tau, z = draw(2)
    coeffs = draw(KZG_SIZE)
    total = {name: 0 for name in kernels.LAUNCHES}
    steps = {}

    def run(step, fn):
        kernels.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[step] = (time.perf_counter() - t, dict(kernels.LAUNCHES))
        for name, k in steps[step][1].items():
            total[name] += k
        return out

    torch.cuda.reset_peak_memory_stats(device)
    srs = run("setup_insecure", lambda: kzg.setup_insecure(KZG_SIZE, tau, device))
    commitment = run("commit", lambda: kzg.commit(srs, coeffs))
    proof, y = run("open_at", lambda: kzg.open_at(srs, coeffs, z))
    peak = torch.cuda.max_memory_allocated(device)
    t = time.perf_counter()
    ok = kzg.verify(srs, commitment, z, y, proof)
    rejected = not kzg.verify(srs, commitment, z, (y + 1) % bn254.R, proof)
    t_verify = time.perf_counter() - t

    host = srs.g1_points_host()
    for i in (0, 1, 2, KZG_SIZE - 1):
        if host[i] != bn254.h_ec_mul_jac_f(pow(tau, i, bn254.R), bn254.G1_GEN):
            raise AssertionError(f"SRS point {i} is not [tau^{i}]G1")
    if y != _host_eval(coeffs, z):
        raise AssertionError("open_at's value differs from the host evaluation")
    if not ok or not rejected:
        raise AssertionError(f"verify: right value {ok}, wrong value rejected {rejected}")
    on_path = ("mont_mul", "mont_pow", "point_add", "point_add_masked", "point_scan_step")
    require_launches("KZG commit", steps["commit"][1], on_path)
    require_launches("KZG open", steps["open_at"][1], on_path)
    require_launches("KZG setup", steps["setup_insecure"][1], ("mont_mul", "mont_pow"))

    log(f"[kzg] {KZG_SIZE}-point SRS on the card, {KZG_SIZE} coefficients: verify True, "
        "a wrong value rejected, p(z) equals the host evaluation")
    for step, (secs, launched) in steps.items():
        log(f"[kzg] {step}: {secs:.3f} s, launches {launched}")
    log(f"[kzg] verify twice (host pairing): {t_verify:.3f} s")
    log(f"[kzg] max_memory_allocated: {peak / 2**20:.1f} MiB")
    device_profile("kzg commit", lambda: kzg.commit(srs, coeffs))
    device_profile("kzg setup_insecure", lambda: kzg.setup_insecure(KZG_SIZE, tau, device))
    return total


def phase_madd(device, points) -> dict:
    """`bn254.point_madd_unsafe` (kernel D) on 2^17 pairs of distinct points,
    against the complete add (kernel B) and the host."""
    F = bn254.FqOps()
    xs, ys, _ = points
    half = xs.shape[1] // 2
    ax, ay, bx, by = (t.contiguous() for t in (xs[:, :half], ys[:, :half], xs[:, half:], ys[:, half:]))
    p = bn254.from_affine(F, ax, ay)
    kernels.reset_launches()
    t = time.perf_counter()
    out, bad = bn254.point_madd_unsafe(F, p, bx, by)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    require_launches("mixed add", launches, ("point_madd",))
    if bool(bad.any()):
        raise AssertionError("the mixed add raised `bad` on distinct points")
    full = msm.ECGroup(F).add(p, bn254.from_affine(F, bx, by))
    got, ref = bn254.to_affine(F, out), bn254.to_affine(F, full)
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError("the mixed add differs from the complete add")
    k = 4
    pts = msm.host_points(F, xs[:, [0, 1, 2, 3, half, half + 1, half + 2, half + 3]],
                          ys[:, [0, 1, 2, 3, half, half + 1, half + 2, half + 3]],
                          torch.zeros(2 * k, dtype=torch.bool))
    have = list(zip(map(int, F.to_int(got[0][:, :k])), map(int, F.to_int(got[1][:, :k]))))
    if have != [bn254.h_ec_add(pts[i], pts[k + i]) for i in range(k)]:
        raise AssertionError("the mixed add differs from the host's add")
    log(f"[madd] {half} mixed adds through bn254.point_madd_unsafe: bad = False, equal to the "
        f"complete add and to the host; {secs * 1e3:.3f} ms, launches {launches}")
    return launches


def main() -> int:
    t0 = time.perf_counter()
    phase_environment()
    device = torch.device("cuda")
    phase_build(device)
    timing = phase_kernels(device)
    phase_golden(device)
    paths = [phase_slice(device)]
    points = test_points(device)
    paths += [phase_msm(device, points), phase_kzg(device), phase_madd(device, points)]
    del points
    paths += [phase_recursion(device), phase_stark_wrap(device)]
    names = [*KERNEL_WORK, "poseidon2", "poseidon_fr"]
    launches = {name: sum(path[name] for path in paths) for name in names}
    require_launches("main", launches, names)
    rows = [
        {"name": name, **kernels.KERNELS[name],
         "launches": launches[name], **timing[name]}
        for name in names
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
