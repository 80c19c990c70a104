"""Poseidon2 Merkle trees over (..., N, k) rows: leaves hashed by the sponge,
every level one batched 2-to-1 compression, openings gathered on the
device and brought to the host in one transfer."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from . import gl, poseidon


def commit_digests(leaf_digests: torch.Tensor) -> List[torch.Tensor]:
    """Levels over (..., N, 4) leaf digests, N a power of two:
    [leaves, ..., root (..., 1, 4)]; on a CUDA tensor one launch."""
    n = leaf_digests.shape[-2]
    assert n & (n - 1) == 0 and n >= 1
    return [leaf_digests] + poseidon.merkle_levels(leaf_digests)


def open_batched(levels: List[torch.Tensor], idx: torch.Tensor) -> np.ndarray:
    """Sibling digests for leaf indices idx (..., Q) of trees whose levels
    are (..., N_l, 4): one device gather per level, one host transfer.
    Returns uint64 (..., Q, depth, 4), bottom-up."""
    cur = idx
    sibs = []
    for level in levels[:-1]:
        sib = (cur ^ 1)[..., None].expand(cur.shape + (4,))
        sibs.append(torch.gather(level, -2, sib))
        cur = cur >> 1
    if not sibs:
        return np.zeros(tuple(idx.shape) + (0, 4), dtype=np.uint64)
    return gl.to_int(torch.stack(sibs, dim=-2))


def roots(levels: List[torch.Tensor]) -> np.ndarray:
    """Root digests of (batched) trees as uint64 (..., 4), one transfer."""
    return gl.to_int(levels[-1][..., 0, :])


@dataclass
class MerkleTree:
    """levels[0] = leaf digests (N, 4) ... levels[-1] = root (1, 4)."""

    levels: List[torch.Tensor]

    def root(self) -> list[int]:
        return [int(v) for v in roots(self.levels)]

    def open(self, index: int) -> list[list[int]]:
        """Sibling digests bottom-up for one leaf index (host ints)."""
        return self.open_many([index])[0]

    def open_many(self, indices) -> list[list[list[int]]]:
        """[paths[q][level][4] for q in indices]."""
        idx = torch.as_tensor(list(indices), dtype=torch.int64, device=self.levels[0].device)
        digs = open_batched(self.levels, idx)
        return [[[int(v) for v in lv] for lv in path] for path in digs]


def commit_leaves(leaves: torch.Tensor) -> List[torch.Tensor]:
    """Hash (..., N, k) rows to digests, then build the levels.  Any row
    width k; the rows are read through their strides, so the transpose of a
    (k, N) column matrix is hashed where it lies."""
    return commit_digests(poseidon.hash_elements(leaves))


def commit_tree(leaves: torch.Tensor) -> MerkleTree:
    """One tree over (N, k) rows, as the AIR prover commits its wide trace."""
    assert leaves.dim() == 2
    return MerkleTree(commit_leaves(leaves))
