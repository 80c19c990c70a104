"""Poseidon2-Fr Merkle tree — port of eigen_zeth_tpu/models/merkle_fr.py.

The vector commitment of the final wrap (models/air_wrap.py): a digest is
ONE Fr element, so an opening path is one element a level and the
in-circuit path check one Poseidon2-Fr permutation a level; leaves are
Goldilocks rows packed 3 to an Fr element.

`commit_rows_gl` commits an (n, C) int64 matrix of canonical Goldilocks
rows on its device: on a CUDA tensor through kernel F (the leaf sponge,
`ezt_poseidon_fr_hash_rows`, reading the rows through their strides, then
the whole tree in one `ezt_poseidon_fr_merkle_levels` launch); on a CPU
tensor on the host, over numpy arrays of python ints.  Both give the levels
of the JAX package's host commit (`commit_packed_host`, its native engine),
bit for bit.  A device tree keeps its levels on the card as (n, 4) int64
words (ops/poseidon_fr.py) and transfers only what it opens.  Verification is
host math over python ints.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import kernels
from ..ops import poseidon_fr as pfr


@dataclass
class MerkleTreeFr:
    """levels[0] = leaf digests ... levels[-1] = [root].  A level is a list
    of python ints (host commits) or an (n, 4) int64 tensor of words
    (device commits)."""

    levels: List

    @property
    def num_leaves(self) -> int:
        return len(self.levels[0])

    def level_ints(self, j: int) -> list:
        lv = self.levels[j]
        return pfr.ints_from_words(lv) if isinstance(lv, torch.Tensor) else [int(v) for v in lv]

    def root(self) -> int:
        return self.level_ints(len(self.levels) - 1)[0]

    def open_many(self, indices) -> list[list[int]]:
        """[path[level] for level] per index; each path entry is the
        sibling digest (one Fr element).  One gather and transfer a level."""
        cur = np.asarray([int(i) for i in indices], dtype=np.int64)
        cols = []
        for level in self.levels[:-1]:
            sib = cur ^ 1
            if isinstance(level, torch.Tensor):
                idx = torch.from_numpy(sib).to(level.device)
                cols.append(pfr.ints_from_words(level[idx]))
            else:
                cols.append([int(level[s]) for s in sib])
            cur = cur >> 1
        return [[col[q] for col in cols] for q in range(len(indices))]

    def open(self, index: int) -> list[int]:
        return self.open_many([index])[0]


# ---------------------------------------------------------------------------
# host construction (python ints)


def _leaf_digests_host(packed_rows: list[list[int]]) -> list[int]:
    return [pfr.hash_elements_host(row, tag="leaf") for row in packed_rows]


def commit_packed_host(packed_rows: list[list[int]]) -> MerkleTreeFr:
    n = len(packed_rows)
    assert n & (n - 1) == 0 and n >= 1
    level = _leaf_digests_host(packed_rows)
    levels = [level]
    while len(level) > 1:
        level = [pfr.hash_two_host(level[i], level[i + 1]) for i in range(0, len(level), 2)]
        levels.append(level)
    return MerkleTreeFr(levels=levels)


# ---------------------------------------------------------------------------
# construction on the rows' device


def commit_rows_gl(rows: torch.Tensor) -> MerkleTreeFr:
    """Commit (n, C) canonical Goldilocks rows (int64, any strides; n a
    power of two) under Poseidon2-Fr: on a CUDA tensor with kernel F, on a
    CPU tensor with the host batches of ops/poseidon_fr.py (as the JAX
    package commits on its host)."""
    n = rows.shape[0]
    assert n & (n - 1) == 0 and n >= 1
    if rows.is_cuda:
        digests = kernels.poseidon_fr_hash_rows(rows)
        return MerkleTreeFr(levels=[digests] + kernels.poseidon_fr_merkle_levels(digests))
    packed = pfr.pack_gl_rows_host(gl.to_int(rows))
    leaves = pfr.hash_rows_host(packed)
    return MerkleTreeFr(levels=[list(leaves)] + [list(lv) for lv in pfr.merkle_levels_host(leaves)])


# ---------------------------------------------------------------------------
# host verification


def verify_path_packed(root: int, index: int, packed_row: list[int], path: list[int]) -> bool:
    digest = pfr.hash_elements_host([int(v) % pfr.R for v in packed_row], tag="leaf")
    idx = int(index)
    for sib in path:
        if idx & 1:
            digest = pfr.hash_two_host(int(sib), digest)
        else:
            digest = pfr.hash_two_host(digest, int(sib))
        idx >>= 1
    return digest == int(root)


def verify_path_gl(root: int, index: int, leaf_values: list[int], path: list[int]) -> bool:
    """Leaf given as raw Goldilocks values (packed on the fly)."""
    return verify_path_packed(root, index, pfr.pack_gl_host(leaf_values), path)
