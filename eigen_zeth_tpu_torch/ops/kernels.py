"""The hand-written CUDA kernels of the port: build, wrappers, plain versions.

Two kernels replace the Pallas kernels that the batch proof reaches:

  mont_mul   csrc/mont_mul.cu   replaces eigen_zeth_tpu/ops/pallas/mont_pl.py:30
  point_add  csrc/point_add.cu  replaces eigen_zeth_tpu/ops/pallas/ec_pl.py:118

Each source notes what bounds it on the H100 and what its design does about
it.  The sources are compiled with nvcc for sm_90a into one shared library
with a plain C interface, at first use, into `_build/<hash of the sources>/`
next to this package, and loaded with ctypes.

Each wrapper takes its plain PyTorch version only for a CPU tensor.  For a
CUDA tensor it launches the kernel or raises; nothing falls back.  Each
launch adds one to `LAUNCHES[name]`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

KERNELS = {
    "mont_mul": {
        "route": "cuda",
        "source": "eigen_zeth_tpu_torch/csrc/mont_mul.cu",
        "replaces": "eigen_zeth_tpu/ops/pallas/mont_pl.py:30",
    },
    "point_add": {
        "route": "cuda",
        "source": "eigen_zeth_tpu_torch/csrc/point_add.cu",
        "replaces": "eigen_zeth_tpu/ops/pallas/ec_pl.py:118",
    },
}

LAUNCHES = {name: 0 for name in KERNELS}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> Path:
    """Compile csrc/*.cu into the shared library (once per source hash).

    Returns the library path; the ptxas report (registers, spills) sits
    beside it as ptxas.log."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libezt_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libezt_kernels.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)] + [str(s) for s in sources if s.suffix == ".cu"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "ptxas.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def ptxas_report() -> str:
    return (build().parent / "ptxas.log").read_text()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp = ctypes.c_void_p
            lib.ezt_mont_mul.argtypes = [vp, vp, vp, ctypes.c_longlong, vp, ctypes.c_uint, vp]
            lib.ezt_mont_mul.restype = ctypes.c_int
            lib.ezt_point_add.argtypes = [vp] * 9 + [ctypes.c_longlong, vp, ctypes.c_uint, vp]
            lib.ezt_point_add.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check_limbs(name: str, tensors) -> int:
    """All (16, n) int32, contiguous, on one CUDA device; returns n."""
    first = tensors[0]
    for t in tensors:
        if t.device != first.device or t.device.type != "cuda":
            raise ValueError(f"{name}: operands must share one CUDA device")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
        if t.dim() != 2 or t.shape != first.shape or t.shape[0] != 16:
            raise ValueError(f"{name}: expected matching (16, n) limbs, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: limbs must be contiguous")
    return first.shape[1]


def _q_words(ctx) -> ctypes.Array:
    return (ctypes.c_uint32 * 8)(*ctx.q_words)


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


# ---------------------------------------------------------------------------
# kernel A: Montgomery multiply


def mont_mul(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b·R^{-1} mod ctx.q on (16, n) int32 limbs (canonical in and out)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(ctx, a, b)
    n = _check_limbs("mont_mul", (a, b))
    out = torch.empty_like(a)
    if n == 0:
        return out
    lib = _load()
    q = _q_words(ctx)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.ezt_mont_mul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
            ctypes.cast(q, ctypes.c_void_p), ctx.n0_32, stream,
        )
    _raise_on("mont_mul", rc)
    LAUNCHES["mont_mul"] += 1
    return out


def mont_mul_plain(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel A: CIOS over 16-bit limbs on int64
    tensors, with the carries deferred.

    Step i adds a_i·b at limb i, takes m = t_i·n0 mod 2^16, adds m·q at limb
    i (which clears t_i mod 2^16) and pushes t_i's high part up one limb.
    Limbs stay below 2^39, far inside int64.  The top 16 limbs are then
    normalised and reduced below q, as the kernel does."""
    from .bigint import MASK, _normalize

    a64 = a.to(torch.int64)
    b64 = b.to(torch.int64)
    t = torch.zeros((33,) + tuple(a.shape[1:]), dtype=torch.int64, device=a.device)
    q = ctx.q_limbs(a.device).reshape((16,) + (1,) * (a.dim() - 1))
    for i in range(16):
        t[i : i + 16] += a64[i] * b64
        m = ((t[i] & MASK) * ctx.n0_16) & MASK
        t[i : i + 16] += m * q
        t[i + 1] += t[i] >> 16
    hi, extra = _normalize(t[16:32], passes=3)
    return ctx._cond_sub_q(hi, extra).to(torch.int32)


# ---------------------------------------------------------------------------
# kernel B: complete Jacobian G1 add


def point_add(ctx, p, q):
    """Complete G1 Jacobian add on (16, n) int32 coordinate limbs.

    p, q: (x, y, z) tuples; returns (x3, y3, z3)."""
    tensors = tuple(p) + tuple(q)
    if all(t.device.type == "cpu" for t in tensors):
        return point_add_plain(ctx, p, q)
    n = _check_limbs("point_add", tensors)
    outs = tuple(torch.empty_like(tensors[0]) for _ in range(3))
    if n == 0:
        return outs
    lib = _load()
    qw = _q_words(ctx)
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ezt_point_add(
            *(t.data_ptr() for t in tensors), *(o.data_ptr() for o in outs), n,
            ctypes.cast(qw, ctypes.c_void_p), ctx.n0_32, stream,
        )
    _raise_on("point_add", rc)
    LAUNCHES["point_add"] += 1
    return outs


def point_add_plain(ctx, p, q):
    """Plain PyTorch version of kernel B: bn254.point_add over the plain
    field ops (no kernel launch)."""
    from . import bn254

    F = bn254.FqOps(ctx, plain=True)
    out = bn254.point_add(F, bn254.PointJ(*p), bn254.PointJ(*q))
    return tuple(out)
