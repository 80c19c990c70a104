"""The single-device chunk-commit step and the multi-device dry run — port
of the repository's `__graft_entry__.py` (`entry` :25, `dryrun_multichip` :67).

`entry()` returns the prover's per-chunk commit core as a function and its
example input: a trace column's coset LDE (NTT), Poseidon leaf hashes over
the LDE domain and their Merkle root; on the card the hashes and the tree
are kernel E.

`dryrun_multichip(n)` lays a (chunk, domain) mesh over n shard positions
(the cards, round-robin: logical shards where there are fewer cards) and
runs one distributed proving step on it: a domain-sharded NTT and its
inverse per chunk position (held bit for bit to the one-device `ntt` and
to the input), the IntGroup MSM over the same mesh (held to numpy),
`msm_dist_g1` over the domain axis, whose last step is the pairwise tree
of BN254 G1 adds across shards (held to the one-device `msm` and to the
host's scalar multiplication by the points' known logs), and the host
Poseidon sponge over the NTT's output, where commitments cross to the
host's Fiat-Shamir transcript.  The sizes of the NTT and the MSM are
arguments, small by default.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import ntt as nttm
from ..ops import poseidon

ENTRY_N = 1 << 8  # trace rows of the chunk-commit step, as in the JAX entry
ENTRY_BLOWUP = 2


def chunk_commit_step(coeffs: torch.Tensor, blowup: int = ENTRY_BLOWUP) -> torch.Tensor:
    """Trace column (n,) -> coset LDE -> Merkle root (4,) over the LDE domain."""
    evals = nttm.lde(coeffs, blowup)
    digests = poseidon.hash_elements(evals[:, None])  # a leaf per evaluation point
    return poseidon.merkle_levels(digests)[-1][0]


def entry(device="cuda"):
    """(function, example args) of the single-device forward step on `device`
    (the card unless the caller names another)."""
    rng = np.random.default_rng(0)
    x = gl.from_int(rng.integers(0, gl.P, ENTRY_N, dtype=np.uint64), device)
    return chunk_commit_step, (x,)


def _log(t0: float, msg: str) -> None:
    print(f"[dryrun +{time.perf_counter() - t0:6.1f}s] {msg}", file=sys.stderr, flush=True)


def dryrun_multichip(n_devices: int, devices=None, *, ntt_log2: int | None = None,
                     g1=None, scalar_bits: int = 8) -> dict:
    """One distributed proving step on n_devices shard positions over
    `devices` (default: the cards).  ntt_log2: the sharded NTT's size
    (default max(256, 16·n_domain) elements); g1: (xs, ys, dlogs), affine
    G1 points on the first shard's device and their discrete logs, for
    `msm_dist_g1` (default: 8 made with `msm.gen_test_points`), with
    random scalars of scalar_bits bits (4-bit windows up to 32 bits, the
    MSM's default window above).  Raises where a result differs from its
    one-device or host reference; returns what it checked and the seconds
    of each step."""
    from ..ops import bn254
    from ..ops import msm as msmm
    from . import mesh as meshm
    from .msm_dist import msm_dist_g1, msm_dist_int_mock
    from .ntt_dist import intt_sharded, ntt_sharded

    t0 = time.perf_counter()
    times = {}
    shards = meshm.logical_shards(n_devices, devices)
    n_chunk = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_domain = n_devices // n_chunk
    mesh = meshm.make_mesh(n_domain=n_domain, n_chunk=n_chunk, devices=shards)

    rng = np.random.default_rng(1)
    n_small = max(256, 16 * n_domain)
    n = n_small if ntt_log2 is None else 1 << ntt_log2
    rows = 1 << ((n.bit_length() - 1) // 2)
    while n // rows < n_domain or rows < n_domain:
        rows *= 2

    # the domain-sharded NTT and its inverse at each chunk position (its own
    # row of the mesh)
    _log(t0, f"mesh ({n_chunk} chunk x {n_domain} domain); sharded NTT of {n}...")
    t = time.perf_counter()
    outs = []
    for c in range(n_chunk):
        row = meshm.Mesh((mesh.grid[c],))
        x = gl.from_int(rng.integers(0, gl.P, n, dtype=np.uint64), shards[0])
        y = ntt_sharded(x, row, rows=rows)
        back = intt_sharded(y, row, rows=rows)
        y = torch.cat([s.to(shards[0]) for s in y])
        if not torch.equal(y, nttm.ntt(x)):
            raise AssertionError("the sharded NTT differs from the one-device ntt")
        if not torch.equal(torch.cat([s.to(shards[0]) for s in back]), x):
            raise AssertionError("intt_sharded does not invert ntt_sharded")
        outs.append(y)
    times["ntt_sharded + intt_sharded"] = time.perf_counter() - t

    _log(t0, "sharded NTT ok; IntGroup distributed MSM...")
    t = time.perf_counter()
    values = rng.integers(0, 1 << 32, size=n_small, dtype=np.uint64)
    scalars = [int(s) for s in rng.integers(0, 1 << 31, size=n_small)]
    digits = torch.from_numpy(msmm.scalar_digits(scalars, c=4, nbits=32).astype(np.int64))
    total = msm_dist_int_mock(mesh, torch.from_numpy(values.astype(np.int64)), digits, c=4)
    expect = sum(int(v) * s for v, s in zip(values, scalars)) % (1 << 32)
    if total != expect:
        raise AssertionError(f"IntGroup distributed MSM {total} != {expect}")
    times["IntGroup msm_dist"] = time.perf_counter() - t

    # the real BN254 G1 MSM over the domain axis: window sums per shard, the
    # pairwise tree of group adds across shards, the Horner combine
    _log(t0, "IntGroup MSM ok; BN254 G1 distributed MSM...")
    xs, ys, dlogs = msmm.gen_test_points(3, device=shards[0]) if g1 is None else g1
    n_pts = xs.shape[1]
    bound = min(bn254.R, 1 << scalar_bits)
    ec_scalars = [int.from_bytes(rng.bytes(32), "little") % bound for _ in range(n_pts)]
    c = 4 if scalar_bits <= 32 else msmm.DEFAULT_C
    F = bn254.FqOps()
    P = bn254.from_affine(F, xs, ys, is_inf=torch.zeros(n_pts, dtype=torch.bool,
                                                        device=xs.device))
    ec_digits = msmm.digits_from_limbs(msmm._limbs_tensor(ec_scalars, xs.device), c,
                                       nbits=min(scalar_bits, 254))
    t = time.perf_counter()
    dist = bn254.to_affine(F, msm_dist_g1(P, ec_digits, mesh, c))
    times["msm_dist_g1"] = time.perf_counter() - t
    t = time.perf_counter()
    one = bn254.to_affine(F, msmm.msm(F, P, ec_digits, c))
    times["msm (one device)"] = time.perf_counter() - t
    want = bn254.h_ec_mul_jac_f(sum(s * k for s, k in zip(ec_scalars, dlogs)) % bn254.R,
                                bn254.G1_GEN)
    for what, (ax, ay) in (("msm_dist_g1", dist), ("the one-device msm", one)):
        if (int(F.to_int(ax)), int(F.to_int(ay))) != want:
            raise AssertionError(f"{what} differs from the host's scalar multiplication")

    # the transcript commit over the sharded NTT's output, on the host
    _log(t0, "BN254 G1 MSM ok; transcript commit...")
    root = poseidon.hash_elements_host([int(v) for v in gl.to_int(outs[0][:8])])
    if len(root) != 4:
        raise AssertionError("the host sponge did not give a digest")
    return {"mesh": (n_chunk, n_domain), "devices": [str(d) for d in shards], "n": n,
            "rows": rows, "int_msm": total, "ec_points": n_pts, "root": root, "times": times}
