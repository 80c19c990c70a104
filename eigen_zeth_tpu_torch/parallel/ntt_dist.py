"""Distributed NTT: the evaluation domain sharded over the mesh's domain
axis — port of eigen_zeth_tpu/parallel/ntt_dist.py.

The four-step factorization n = R·C (ops/ntt.py) splits the transform into
two banks of local NTTs separated by one global transpose.  With the
(R, C) matrix sharded along its columns over d domain positions:

  1. size-R NTTs along axis 0            — local
  2. the four-step twiddle                — local (each shard its columns)
  3. exchange: cols-sharded -> rows-sharded, (R, C/d) -> (R/d, C)
  4. size-C NTTs along axis 1             — local
  5. exchange back, (R/d, C) -> (R, C/d), and a local transpose to the
     natural order's row blocks

The JAX package's two `all_to_all`s become `all_to_all` below: block
copies between the shards' tensors (`.to(device)`), one controller driving
every shard.  The local NTTs are the port's butterfly stages
(`ntt.raw`).  Natural order in, natural order out: shard p holds
X[p·n/d : (p+1)·n/d] on domain position p's device, bit for bit the
one-device `ntt`.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..ops import goldilocks as gl
from ..ops import ntt as nttm
from .mesh import Mesh


def all_to_all(shards: Sequence[torch.Tensor], devices, split_axis: int,
               concat_axis: int) -> List[torch.Tensor]:
    """The tiled all_to_all of the JAX package over shard tensors: shard p
    splits along split_axis into d blocks, block q goes to position q, and
    position q concatenates what it receives along concat_axis in order
    of p, on its own device."""
    d = len(shards)
    pieces = [torch.chunk(s, d, dim=split_axis) for s in shards]
    return [torch.cat([pieces[p][q].to(devices[q]) for p in range(d)], dim=concat_axis)
            for q in range(d)]


def _col_shards(x: torch.Tensor, R: int, C: int, devices) -> List[torch.Tensor]:
    """(n,) natural order -> d column blocks (R, C/d) of the (R, C) view."""
    d = len(devices)
    m = x.reshape(R, C)
    return [m[:, q * C // d:(q + 1) * C // d].contiguous().to(devices[q]) for q in range(d)]


def ntt_sharded(x, mesh: Mesh, rows: int, inverse: bool = False) -> List[torch.Tensor]:
    """NTT of n Goldilocks elements over the mesh's domain axis.

    x: one (n,) int64 tensor in natural order, or the d shards that
    `ntt_sharded` returns (shard p: elements [p·n/d, (p+1)·n/d)).  rows (R)
    picks the split n = R·C; R and C must both divide by d.  Returns the d
    output shards in natural order, shard p on the domain axis' p-th
    device."""
    devices = mesh.domain_devices()
    d = len(devices)
    if isinstance(x, torch.Tensor):
        n = x.shape[-1]
    else:
        n = sum(s.shape[-1] for s in x)
    plan0 = nttm.make_four_step_plan(n, rows, inverse, devices[0])
    R, C = plan0.rows, plan0.cols
    if R % d or C % d:
        raise ValueError(f"the split {R} x {C} does not divide over {d} shards")
    if isinstance(x, torch.Tensor):
        blocks = _col_shards(x, R, C, devices)
    else:
        # row blocks of the (R, C) view -> its column blocks
        blocks = all_to_all([s.reshape(R // d, C) for s in x], devices, 1, 0)

    out = []
    for q, (blk, dev) in enumerate(zip(blocks, devices)):
        plan = nttm.make_four_step_plan(n, rows, inverse, dev)
        blk = nttm.raw(blk.transpose(0, 1), inverse).transpose(0, 1)  # axis 0, size R
        out.append(gl.mul(blk, plan.twiddle[:, q * C // d:(q + 1) * C // d]))
    blocks = all_to_all(out, devices, 0, 1)  # (R/d, C)
    blocks = [nttm.raw(b, inverse) for b in blocks]  # axis 1, size C: Y's k1-blocks
    blocks = all_to_all(blocks, devices, 1, 0)  # (R, C/d) = Y[:, block q]
    shards = []
    for blk, dev in zip(blocks, devices):
        flat = blk.transpose(0, 1).reshape(-1)  # X[k1 + k2·R] for k2 in block q
        plan = nttm.make_four_step_plan(n, rows, inverse, dev)
        shards.append(flat if plan.scale is None else gl.mul(flat, plan.scale))
    return shards


def intt_sharded(x, mesh: Mesh, rows: int) -> List[torch.Tensor]:
    return ntt_sharded(x, mesh, rows, True)
