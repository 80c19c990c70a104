"""Device mesh of the proving pipeline — port of eigen_zeth_tpu/parallel/mesh.py.

Two axes, as in the JAX package:

  * 'chunk'  — data parallelism over a batch's chunks (each chunk-axis
               position proves its own chunks; no traffic between them)
  * 'domain' — the polynomial evaluation domain sharded inside one
               transform (parallel/ntt_dist.py), and an MSM's points
               (parallel/msm_dist.py)

The JAX package is one process that `shard_map`s over `jax.devices()`; so
is the port: a `Mesh` is a (chunk, domain) grid of `torch.device`s driven
by one controller, with no process group.  A device may appear more than
once: logical shards, so that the 2-, 4- and 8-way schedules run on the CPU
in the tests and on a machine with one card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

CHUNK_AXIS = "chunk"
DOMAIN_AXIS = "domain"


@dataclass(frozen=True)
class Mesh:
    grid: Tuple[Tuple[torch.device, ...], ...]  # (n_chunk, n_domain)

    @property
    def shape(self) -> dict:
        return {CHUNK_AXIS: len(self.grid), DOMAIN_AXIS: len(self.grid[0])}

    def domain_devices(self, chunk: int = 0) -> list:
        """The devices along the domain axis at one chunk position."""
        return list(self.grid[chunk])

    def chunk_devices(self, domain: int = 0) -> list:
        """The devices along the chunk axis at one domain position."""
        return [row[domain] for row in self.grid]


def default_devices() -> list:
    """Every CUDA device this process sees, or raise: the mesh's devices
    are the cards unless the caller names others (the CPU, say)."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass devices= (e.g. the CPU) explicitly")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def logical_shards(n: int, devices=None) -> list:
    """n shard positions laid round-robin over `devices` (default: the cards)."""
    devices = default_devices() if devices is None else [torch.device(d) for d in devices]
    return [devices[i % len(devices)] for i in range(n)]


def make_mesh(n_domain: int | None = None, n_chunk: int = 1, devices=None) -> Mesh:
    """A (chunk, domain) mesh over the first n_chunk·n_domain of `devices`
    (default: the cards; repeat a device for logical shards); n_domain
    defaults to all of them over n_chunk.  Asking for more positions than
    devices given raises."""
    devices = default_devices() if devices is None else [torch.device(d) for d in devices]
    if n_domain is None:
        n_domain = len(devices) // n_chunk
    if n_chunk < 1 or n_domain < 1 or n_chunk * n_domain > len(devices):
        raise ValueError(f"need {n_chunk} x {n_domain} devices, have {len(devices)}")
    flat = devices[: n_chunk * n_domain]
    return Mesh(tuple(tuple(flat[c * n_domain:(c + 1) * n_domain]) for c in range(n_chunk)))
