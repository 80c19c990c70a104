"""Converters from the JAX package's values to the port's tensors and back.

They take what the JAX package hands out on the host — numpy arrays and
python ints — so this module imports neither package's JAX code:

  GF(lo, hi) uint32 planes      <-> int64 tensor of canonical Goldilocks values
  (16, B) uint32 limb planes    <-> (16, B) int32 tensor (same 16-bit limbs)
  a ProvingKey / VerifyingKey / R1CS of the JAX package -> the port's
  the fields of an Srs / G1Table of the JAX package    -> the port's
  (16, ...) Fr limb planes (Montgomery or regular)      -> (..., 4) int64 Fr words
  a MerkleTreeFr of the JAX package (its levels)        -> the port's

A proving key's pk.npz arrays, which both packages write alike, become the
port's ProvingKey through `models.crs.proving_key_from_arrays`.

The recursion tier (models/air.py, models/recursion.py,
`BatchProver(recursion=True)`) carries no parameters across: its inputs are
the chunk-proof dicts, plain JSON that both packages read as it is, and its
AIR is built from the same constants on both sides.  Nothing here serves it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models import groth16, kzg, merkle_fr
from .ops import bn254, msm
from .ops import poseidon_fr as pfr


def gf_to_tensor(lo, hi, device) -> torch.Tensor:
    """GF(lo, hi) uint32 planes -> int64 tensor of the same uint64 values."""
    v = np.asarray(lo, dtype=np.uint64) | (np.asarray(hi, dtype=np.uint64) << np.uint64(32))
    return torch.from_numpy(np.ascontiguousarray(v).view(np.int64)).to(device)


def tensor_to_gf(x: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """int64 Goldilocks tensor -> (lo, hi) numpy uint32 planes."""
    v = np.ascontiguousarray(x.detach().cpu().numpy()).view(np.uint64)
    return (v & np.uint64(0xFFFFFFFF)).astype(np.uint32), (v >> np.uint64(32)).astype(np.uint32)


def limbs_to_tensor(limbs, device) -> torch.Tensor:
    """(16, ...) uint32 limb planes -> int32 tensor (limbs are < 2^16)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(limbs, dtype=np.uint32)).astype(np.int32)).to(device)


def tensor_to_limbs(x: torch.Tensor) -> np.ndarray:
    """(16, ...) int32 limb tensor -> uint32 numpy planes."""
    return x.detach().cpu().numpy().astype(np.uint32)


def _same_fields(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def r1cs_from(r1cs) -> groth16.R1CS:
    return _same_fields(groth16.R1CS, r1cs)


def proving_key_from(pk) -> groth16.ProvingKey:
    return _same_fields(groth16.ProvingKey, pk)


def verifying_key_from(vk) -> groth16.VerifyingKey:
    return _same_fields(groth16.VerifyingKey, vk)


def srs_from_jax(g1_x, g1_y, g1_inf, g2_tau, device) -> kzg.Srs:
    """The fields of the JAX package's `kzg.Srs`, given as numpy arrays (and
    g2_tau as host ints), as the port's Srs on `device`."""
    inf = torch.from_numpy(np.asarray(g1_inf, dtype=bool).copy()).to(device)
    return kzg.Srs(limbs_to_tensor(g1_x, device), limbs_to_tensor(g1_y, device), inf, g2_tau)


def g1_table_from_jax(txs, tys, tinf, c: int, n: int, device) -> msm.G1Table:
    """The fields of the JAX package's `msm.G1Table`, given as numpy arrays,
    as the port's G1Table on `device`."""
    inf = torch.from_numpy(np.asarray(tinf, dtype=bool).copy()).to(device)
    return msm.G1Table(limbs_to_tensor(txs, device), limbs_to_tensor(tys, device), inf, c, n)


def fr_words_from_limbs(limbs, device, mont: bool = True) -> torch.Tensor:
    """(16, ...) uint32 Fr limb planes (the JAX package's device layout; in
    Montgomery form unless mont=False) -> (..., 4) int64 words of the
    regular values (ops/poseidon_fr.py's device layout)."""
    ctx = bn254.fr()
    return pfr.words_from_ints(ctx.to_int(limbs_to_tensor(limbs, "cpu"), mont=mont), device)


def merkle_tree_fr_from(levels) -> merkle_fr.MerkleTreeFr:
    """The levels of the JAX package's MerkleTreeFr (lists of python ints,
    leaves first) as the port's tree."""
    return merkle_fr.MerkleTreeFr(levels=[[int(v) for v in lv] for lv in levels])

