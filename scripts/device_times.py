#!/usr/bin/env python3
"""Device times of kernels A, B (G1 and G2), C, D, E, F and the power of the
port, for one checkout or several in turn, on one NVIDIA GPU.

    python3 scripts/device_times.py [ROOT ...]

Each ROOT is a checkout that holds `eigen_zeth_tpu_torch/` (default: this
one).  To compare two commits on one card, unpack the other with
`git archive` and name the roots in the order parent, change, change, parent.
Every root runs in a process of its own, builds its kernels from its own
csrc/, and prints one JSON line: per kernel the time of one launch at a batch
where the card's work outlasts the host's enqueue ((16, 2^20) random canonical
Fq elements for A, (16, 2^18) for the point kernels; the operands exceed the
L2 cache), CUDA events around 20 back-to-back launches, median of 3.
The G2 add at (16, 2^18) unmasked and with a fixed mask that passes one
element in 8 (operand p kept), and at the stark wrap's 366,012 phase-1
lanes; the power `mont_pow` to q - 2 (Fermat inversion) at (16, 2^18),
at (16, 2^16), the fixed-base chunk's to_affine, and at (16, 32), the
window sums' to_affine, where it is one warp's chain of dependent products.
Kernel E (Poseidon2 over Goldilocks) through the calls its users make:
`poseidon.perm` on 2^18 states, `poseidon.hash_elements` on the
attestation's (2^21, 216) rows, column-major as the AIR prover hands them
over, `poseidon.hash_two` on a Merkle level of 2^20 strided pairs,
`merkle.commit_digests` over 2^21 leaves (a whole tree, every launch it
makes), with random canonical words; and the host's cost of one
`hash_two` on 1,024 pairs (host clock around 200 calls).  Kernel F
(Poseidon2 over BN254 Fr) through its three wrappers: `poseidon_fr_perm` on
2^14 states (the grind search's batch) and on 2^18, `poseidon_fr_hash_rows`
on the wrap attestation's (2^23, 216) rows, column-major, and
`poseidon_fr_merkle_levels` over 2^23 leaves (a whole tree, one launch)
and over 2^15, 2^16 and 2^17 leaves (the top 15, 16 and 17 levels of the
big tree; a level of at most 2^15 nodes is narrower than the H100's 33,792
resident threads), with random canonical words; and the host's cost of one launch of each on 256
states, rows or leaves.  Only the calls that every version of the port
has are used: the unmasked wrappers and the Poseidon2 and Merkle functions.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BIG_FIELD, BIG_POINT = 1 << 20, 1 << 18
G2_WRAP = 11_712_384 // 32  # the stark wrap's G2 MSM: its phase-1 lanes
POW_BATCHES = (1 << 18, 1 << 16, 32)
E_PERMS, E_ROWS, E_COLS = 1 << 18, 1 << 21, 216
F_PERMS, F_ROWS = (1 << 14, 1 << 18), 1 << 23
F_TOP_LEAVES = (1 << 15, 1 << 16, 1 << 17)
FR_TOP = 0x30644E72E131A029  # the top 64-bit word of r: words below it are canonical


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from eigen_zeth_tpu_torch.models import merkle
    from eigen_zeth_tpu_torch.ops import bn254, kernels, poseidon

    if not torch.cuda.is_available():
        raise SystemExit("device_times: needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def limbs(n):
        t = torch.randint(0, 1 << 16, (16, n), generator=gen, device=dev, dtype=torch.int32)
        t[15] %= bn254.Q >> 240
        return t

    def words(*shape):  # canonical Goldilocks words: below 2^62 < p
        return torch.randint(0, 1 << 62, shape, generator=gen, device=dev, dtype=torch.int64)

    def host_us(fn, reps=200):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        secs = time.perf_counter() - t
        torch.cuda.synchronize()
        return secs / reps * 1e6

    def time_ms(fn, reps=20, groups=3):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(groups):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / reps)
        return statistics.median(times)

    ctx = bn254.fq()
    a, b = limbs(BIG_FIELD), limbs(BIG_FIELD)
    p, q = tuple(limbs(BIG_POINT) for _ in range(3)), tuple(limbs(BIG_POINT) for _ in range(3))
    sgn, flg = (torch.randint(0, 2, (BIG_POINT,), generator=gen, device=dev, dtype=torch.int32)
                for _ in range(2))
    out = {
        "root": root,
        "mont_mul": time_ms(lambda: kernels.mont_mul(ctx, a, b)),
        "point_add": time_ms(lambda: kernels.point_add(ctx, p, q)),
        "point_scan_step": time_ms(lambda: kernels.point_scan_step(ctx, p, q[:2], sgn, flg)),
        "point_madd": time_ms(lambda: kernels.point_madd(ctx, p, q[:2])),
    }
    del a, b, p, q, sgn, flg
    for n, tag in ((BIG_POINT, ""), (G2_WRAP, f"_{G2_WRAP}")):
        p2, q2 = (tuple((limbs(n), limbs(n)) for _ in range(3)) for _ in range(2))
        out["point_add_g2" + tag] = time_ms(lambda: kernels.point_add_g2(ctx, p2, q2))
        if not tag:
            mask = (torch.arange(n, device=dev, dtype=torch.int32) % 8 == 0).to(torch.int32)
            out["point_add_g2_masked"] = time_ms(
                lambda: kernels.point_add_g2(ctx, p2, q2, mask, 0))
        del p2, q2
    for n in POW_BATCHES:
        x = limbs(n)
        out[f"mont_pow_{n}"] = time_ms(lambda: kernels.mont_pow(ctx, x, bn254.Q - 2))
    del x
    states = words(E_PERMS, 12)
    out["poseidon2_perm"] = time_ms(lambda: poseidon.perm(states))
    del states
    wide = words(E_COLS, E_ROWS).T  # column-major rows
    out["poseidon2_hash_rows_wide"] = time_ms(lambda: poseidon.hash_elements(wide), reps=3)
    del wide
    level = words(E_ROWS, 4)
    out["poseidon2_hash_two"] = time_ms(lambda: poseidon.hash_two(level[0::2], level[1::2]))
    before = kernels.LAUNCHES["poseidon2"]
    merkle.commit_digests(level)
    out["poseidon2_tree_launches"] = kernels.LAUNCHES["poseidon2"] - before
    out["poseidon2_tree"] = time_ms(lambda: merkle.commit_digests(level), reps=5)
    small = level[:2048]
    out["poseidon2_host_us"] = host_us(lambda: poseidon.hash_two(small[0::2], small[1::2]))
    del level, small

    def fr_words(*shape):  # canonical Fr values, four words each
        t = words(*shape, 4)
        t[..., 3] = torch.randint(0, FR_TOP, shape, generator=gen, device=dev)
        return t

    for n in F_PERMS:
        states = fr_words(n, 12)
        out[f"poseidon_fr_perm_{n}"] = time_ms(lambda: kernels.poseidon_fr_perm(states))
    out["poseidon_fr_perm_host_us"] = host_us(lambda: kernels.poseidon_fr_perm(states[:256]))
    del states
    wide = words(E_COLS, F_ROWS).T  # column-major rows
    out["poseidon_fr_hash_rows"] = time_ms(lambda: kernels.poseidon_fr_hash_rows(wide), reps=1)
    out["poseidon_fr_hash_rows_host_us"] = host_us(
        lambda: kernels.poseidon_fr_hash_rows(wide[:256]))
    del wide
    leaves = fr_words(F_ROWS)
    out["poseidon_fr_tree"] = time_ms(lambda: kernels.poseidon_fr_merkle_levels(leaves), reps=2)
    for n in F_TOP_LEAVES:
        top = leaves[:n]
        out[f"poseidon_fr_tree_{n}"] = time_ms(lambda: kernels.poseidon_fr_merkle_levels(top))
    out["poseidon_fr_tree_host_us"] = host_us(
        lambda: kernels.poseidon_fr_merkle_levels(leaves[:256]))
    return out


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(measure(sys.argv[2])))
        return 0
    roots = sys.argv[1:] or [str(Path(__file__).resolve().parent.parent)]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for root in roots:
        subprocess.run([sys.executable, __file__, "--one", str(Path(root).resolve())], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
