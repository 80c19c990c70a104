"""Distributed MSM: points partitioned over the mesh's domain axis, window
sums reduced across it — port of eigen_zeth_tpu/parallel/msm_dist.py.

  1. each shard runs the complete-add pipeline (sort, segmented scan,
     bucket sums: `msm.msm_window_sums`) on its own partition of the
     points, on its own device; on the card every group op is kernel B
  2. the shards' window sums are gathered onto a new trailing axis on the
     first shard's device and reduced by a pairwise tree of group adds
     (the EC analog of a psum; EC addition is no reduction op of the
     framework, so the tree is explicit)
  3. the Horner window combine (`msm.horner_windows`) runs last, there

The JAX package's all_gather replicates the sums on every device and each
reduces them; with one controller the tree runs once.  The EC instances
use `ECGroup`; the `IntGroup` mock (wraparound 32-bit adds) checks the
structure against numpy.
"""

from __future__ import annotations

import torch

from ..ops import bn254
from ..ops import msm as msmm
from .mesh import Mesh


def _block(t: torch.Tensor, p: int, d: int, device) -> torch.Tensor:
    """Block p of d contiguous blocks of the last axis, on `device`."""
    step = t.shape[-1] // d
    return t[..., p * step:(p + 1) * step].contiguous().to(device)


def _allreduce_group(G, vals: list, device):
    """Group sum of the shards' elements (leaves (...,) each): gathered onto
    a new trailing axis on `device`, then a pairwise tree of G.add."""
    d = len(vals)
    if d & (d - 1):
        raise ValueError(f"the pairwise tree needs a power-of-two shard count, got {d}")
    gathered = msmm._tmap(lambda *ls: torch.stack([leaf.to(device) for leaf in ls], dim=-1),
                          *vals)
    while d > 1:
        even = msmm._tmap(lambda leaf: leaf[..., 0::2], gathered)
        odd = msmm._tmap(lambda leaf: leaf[..., 1::2], gathered)
        gathered = G.add(even, odd)
        d //= 2
    return msmm._tmap(lambda leaf: leaf[..., 0], gathered)


def msm_dist(G, points, digits: torch.Tensor, mesh: Mesh, c: int = msmm.DEFAULT_C):
    """Distributed MSM core: points (leaves (L, N)) and digits (W, N) split
    over the domain axis on their last axis; returns Σ s_i·P_i (leaves
    (L,)) on the first domain device."""
    devices = mesh.domain_devices()
    d = len(devices)
    if digits.shape[-1] % d:
        raise ValueError(f"{digits.shape[-1]} points do not split over {d} shards")
    sums = [msmm.msm_window_sums(
        G, msmm._tmap(lambda leaf, p=p, dev=dev: _block(leaf, p, d, dev), points),
        _block(digits, p, d, dev), c) for p, dev in enumerate(devices)]
    S = _allreduce_group(G, sums, devices[0])
    return msmm.horner_windows(G, S, digits.shape[0], c)


def msm_dist_g1(points: bn254.PointJ, digits, mesh: Mesh, c: int = msmm.DEFAULT_C):
    return msm_dist(msmm.ECGroup(bn254.FqOps()), points, digits, mesh, c)


def msm_dist_g2(points: bn254.PointJ, digits, mesh: Mesh, c: int = msmm.DEFAULT_C):
    return msm_dist(msmm.ECGroup(bn254.Fq2Ops()), points, digits, mesh, c)


def msm_dist_int_mock(mesh: Mesh, values: torch.Tensor, digits, c: int) -> int:
    """IntGroup-mock distributed MSM (the structural check): values (N,)
    32-bit words as int64, digits (W, N); returns Σ s_i·v_i mod 2^32."""
    out = msm_dist(msmm.IntGroup(), values.reshape(1, -1), digits, mesh, c)
    return int(out[0])
