"""Poseidon2-Fr Merkle trees: a digest is one Fr element, a leaf a row of
Goldilocks values packed three to an Fr element and hashed by the sponge
(tag "leaf"), a node the 2-to-1 compression.  Paths are checked in one batch
(every leaf sponge at once, then one level of every path at once); a whole
tree's root is committed in blocks of rows on the rows' device."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import poseidon_fr as pfr


@dataclass
class PathCheck:
    """A claim: `elements` (Fr ints) are leaf `index` of the tree `root`
    along `path` (the siblings, bottom up)."""

    root: int
    index: int
    elements: list
    path: list


def verify_paths(checks: list, device) -> list[bool]:
    """Each claim checked; the permutations batched over all of them."""
    if not checks:
        return []
    k = max(len(c.elements) for c in checks)
    rows = pfr.from_ints([list(c.elements) + [0] * (k - len(c.elements)) for c in checks], device)
    cur = pfr.hash_rows(rows.reshape(len(checks), k, pfr.LIMBS),
                        [len(c.elements) for c in checks])
    for level in range(max(len(c.path) for c in checks)):
        live = [i for i, c in enumerate(checks) if len(c.path) > level]
        sib = pfr.from_ints([checks[i].path[level] for i in live], device)
        odd = torch.tensor([(checks[i].index >> level) & 1 for i in live], device=device)
        odd = (odd == 1).unsqueeze(-1)
        node = cur[live]
        at = torch.tensor(live, device=device)
        cur[at] = pfr.compress(torch.where(odd, sib, node), torch.where(odd, node, sib))
    return [got == c.root % pfr.R for got, c in zip(pfr.to_ints(cur), checks)]


def commit_root(rows: torch.Tensor, block: int = 1 << 16) -> int:
    """The root of the tree over (N, k) canonical Goldilocks rows (int64,
    N a power of two), `block` rows at a time on the rows' device."""
    n = rows.shape[0]
    assert n & (n - 1) == 0
    level = torch.cat([pfr.hash_rows(pfr.pack_gl_limbs(rows[s : s + block]))
                       for s in range(0, n, block)])
    while level.shape[0] > 1:
        pairs = [(level[s : s + 2 * block : 2], level[s + 1 : s + 2 * block : 2])
                 for s in range(0, level.shape[0], 2 * block)]
        level = torch.cat([pfr.compress(left, right) for left, right in pairs])
    return pfr.to_ints(level)[0]


def commit_root_host(rows: list) -> int:
    """The same root on host python ints, from rows of Goldilocks ints."""
    level = [pfr.hash_elements_host(pfr.pack_gl(r)) for r in rows]
    while len(level) > 1:
        level = [pfr.hash_two_host(level[i], level[i + 1]) for i in range(0, len(level), 2)]
    return level[0]
