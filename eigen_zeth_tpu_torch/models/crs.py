"""Groth16 CRS lifecycle — port of eigen_zeth_tpu/models/crs.py.

The final circuit of the STARK wrap is padded to a fixed leaf count, so one
circuit shape covers every batch; its CRS is generated once per shape
(`generate`, the ceremony-shaped entry point: entropy from a named seed, a
real deployment substitutes a multi-party ceremony's output) and persisted
under artifacts/crs/<shape-key>/ as pk.npz and vk.json.  The verifying key
alone (`vk.json`, small and committable) is what the settlement verifier
pins (`load_pinned_vk`), so a prover swapping its CRS cannot move what the
verifier accepts.

The files are the JAX package's: each package loads the other's.  A proving
key encodes as (N, 2|4, 4) uint64 limb arrays of affine coordinates in one
.npz, with a bool infinity mask per query (the port stores the archive's
members where the JAX package deflates them).  A query the port holds on the
device (`groth16.DevicePoints`) is encoded on the device, and `load` with a
CUDA device puts the queries back there.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import bn254
from ..ops import poseidon_fr as pfr
from . import groth16

QUERIES = (("a_query", False), ("b1_query", False), ("b2_query", True), ("l_query", False),
           ("h_query", False))


def _int_to_limbs(v: int) -> list[int]:
    return [(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4)]


def _limbs_to_int(l) -> int:
    return sum(int(x) << (64 * i) for i, x in enumerate(l))


def _enc_points(points, g2: bool) -> tuple[np.ndarray, np.ndarray]:
    """[(x, y) | ((x0,x1),(y0,y1)) | None, ...] or DevicePoints ->
    (coords (N, 2|4, 4) uint64, inf_mask (N,) bool)."""
    if isinstance(points, groth16.DevicePoints):
        return _enc_device(points)
    width = 4 if g2 else 2
    n = len(points)
    coords = np.zeros((n, width, 4), dtype=np.uint64)
    inf = np.zeros((n,), dtype=bool)
    for i, p in enumerate(points):
        if p is None:
            inf[i] = True
            continue
        if g2:
            (x0, x1), (y0, y1) = p
            vals = [x0, x1, y0, y1]
        else:
            x, y = p
            vals = [x, y]
        for j, v in enumerate(vals):
            coords[i, j] = _int_to_limbs(int(v))
    return coords, inf


def _coords(points: groth16.DevicePoints) -> list:
    if points.g2:
        return [points.x[0], points.x[1], points.y[0], points.y[1]]
    return [points.x, points.y]


def _enc_device(points: groth16.DevicePoints) -> tuple[np.ndarray, np.ndarray]:
    """Out of Montgomery form on the device (one product by 1), then the
    limbs as uint64 words: (N, 2|4, 4)."""
    ctx = bn254.fq()
    cols = []
    for c in _coords(points):
        one = ctx.from_int([1], c.device, mont=False).expand_as(c).contiguous()
        regular = ctx.mont_mul(c, one)
        cols.append(pfr.limbs_to_words(regular).cpu().numpy().view(np.uint64))
    coords = np.ascontiguousarray(np.stack(cols, axis=1))
    return coords, points.inf.cpu().numpy().astype(bool)


def _dec_points(coords: np.ndarray, inf: np.ndarray, g2: bool) -> list:
    out = []
    for i in range(coords.shape[0]):
        if inf[i]:
            out.append(None)
            continue
        vals = [_limbs_to_int(coords[i, j]) for j in range(coords.shape[1])]
        if g2:
            out.append(((vals[0], vals[1]), (vals[2], vals[3])))
        else:
            out.append((vals[0], vals[1]))
    return out


def _dec_device(coords: np.ndarray, inf: np.ndarray, g2: bool, device) -> groth16.DevicePoints:
    ctx = bn254.fq()
    words = torch.from_numpy(np.ascontiguousarray(coords).view(np.int64)).to(device)
    cols = []
    for j in range(coords.shape[1]):
        limbs = pfr.words_to_limbs(words[:, j])
        r2 = ctx.from_int([ctx.R2_mod], device, mont=False).expand_as(limbs).contiguous()
        cols.append(ctx.mont_mul(limbs, r2))
    x, y = ((cols[0], cols[1]), (cols[2], cols[3])) if g2 else (cols[0], cols[1])
    return groth16.DevicePoints(x=x, y=y, inf=torch.from_numpy(inf.astype(bool)).to(device), g2=g2)


def proving_key_from_arrays(arrays, *, device) -> groth16.ProvingKey:
    """A pk.npz's arrays as a ProvingKey: host tuples, or, for a CUDA
    `device`, the five queries as DevicePoints on it."""
    on_card = torch.device(device).type == "cuda"

    def pts(name, g2=False):
        if on_card and name.endswith("_query"):
            return _dec_device(arrays[name], arrays[name + "_inf"], g2, device)
        return _dec_points(arrays[name], arrays[name + "_inf"], g2)

    meta = arrays["meta"]
    return groth16.ProvingKey(
        alpha1=pts("alpha1")[0], beta1=pts("beta1")[0], beta2=pts("beta2", True)[0],
        delta1=pts("delta1")[0], delta2=pts("delta2", True)[0],
        **{name: pts(name, g2) for name, g2 in QUERIES},
        domain=int(meta[0]), num_public=int(meta[1]),
    )


def vk_to_json(vk: groth16.VerifyingKey) -> dict:
    def g1(p):
        return {"x": str(p[0]), "y": str(p[1])} if p else None

    def g2p(p):
        return (
            {"x": [str(p[0][0]), str(p[0][1])], "y": [str(p[1][0]), str(p[1][1])]}
            if p
            else None
        )

    return {
        "protocol": "groth16",
        "curve": "BN128",
        "alpha1": g1(vk.alpha1),
        "beta2": g2p(vk.beta2),
        "gamma2": g2p(vk.gamma2),
        "delta2": g2p(vk.delta2),
        "ic": [g1(p) for p in vk.ic],
    }


def vk_from_json(d: dict) -> groth16.VerifyingKey:
    def g1(p):
        return (int(p["x"]), int(p["y"])) if p else None

    def g2p(p):
        return (
            ((int(p["x"][0]), int(p["x"][1])), (int(p["y"][0]), int(p["y"][1])))
            if p
            else None
        )

    return groth16.VerifyingKey(
        alpha1=g1(d["alpha1"]),
        beta2=g2p(d["beta2"]),
        gamma2=g2p(d["gamma2"]),
        delta2=g2p(d["delta2"]),
        ic=[g1(p) for p in d["ic"]],
    )


def save(dir_path: str, pk: groth16.ProvingKey, vk: groth16.VerifyingKey) -> None:
    os.makedirs(dir_path, exist_ok=True)
    arrays = {}
    for name, g2 in QUERIES:
        coords, inf = _enc_points(getattr(pk, name), g2)
        arrays[name] = coords
        arrays[name + "_inf"] = inf
    for name, p, g2 in (
        ("alpha1", pk.alpha1, False),
        ("beta1", pk.beta1, False),
        ("beta2", pk.beta2, True),
        ("delta1", pk.delta1, False),
        ("delta2", pk.delta2, True),
    ):
        coords, inf = _enc_points([p], g2)
        arrays[name] = coords
        arrays[name + "_inf"] = inf
    arrays["meta"] = np.asarray([pk.domain, pk.num_public], dtype=np.uint64)
    # stored, not deflated: the same arrays and format, which np.load reads
    # either way; affine coordinates hardly compress, and deflating the
    # STARK wrap's 4.8 GB of them took 172 s on an H100 host
    np.savez(os.path.join(dir_path, "pk.npz"), **arrays)
    with open(os.path.join(dir_path, "vk.json"), "w") as f:
        json.dump(vk_to_json(vk), f)


def load(dir_path: str, *, device) -> Optional[Tuple[groth16.ProvingKey, groth16.VerifyingKey]]:
    """The persisted (pk, vk), or None.  With a CUDA `device` the five
    queries come back as DevicePoints on it; otherwise as host tuples."""
    pk_path = os.path.join(dir_path, "pk.npz")
    vk_path = os.path.join(dir_path, "vk.json")
    if not (os.path.exists(pk_path) and os.path.exists(vk_path)):
        return None
    pk = proving_key_from_arrays(np.load(pk_path), device=device)
    with open(vk_path) as f:
        vk = vk_from_json(json.load(f))
    return pk, vk


def load_pinned_vk(dir_path: str) -> Optional[groth16.VerifyingKey]:
    """The settlement verifier's side: only the pinned vk.json — a prover
    regenerating its CRS cannot move what the verifier accepts."""
    vk_path = os.path.join(dir_path, "vk.json")
    if not os.path.exists(vk_path):
        return None
    with open(vk_path) as f:
        return vk_from_json(json.load(f))


def shape_key(parts: List[str]) -> str:
    """Stable directory name for a circuit shape."""
    h = hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]
    return f"shape-{h}"


def generate(r1cs: groth16.R1CS, seed: str = "ezt-groth16-dev", *, device
             ) -> Tuple[groth16.ProvingKey, groth16.VerifyingKey]:
    """Ceremony-shaped CRS generation, deterministic from `seed` (a dev
    stand-in for a multi-party powers-of-tau and phase-2 ceremony, which
    yields the same (pk, vk) structure).  With a CUDA `device` the large
    queries are made on it and stay there."""
    return groth16.setup(r1cs, seed=seed, device=device)
