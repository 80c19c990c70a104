"""The hand-written CUDA kernels of the port: build, wrappers, plain versions.

Four kernels replace the four Pallas kernels of the JAX package:

  A mont_mul         csrc/mont_mul.cu    eigen_zeth_tpu/ops/pallas/mont_pl.py:30
  B point_add        csrc/point_add.cu   eigen_zeth_tpu/ops/pallas/ec_pl.py:118
  C point_scan_step  csrc/scan_step.cu   eigen_zeth_tpu/ops/pallas/ec_pl.py:242
  D point_madd       csrc/point_madd.cu  eigen_zeth_tpu/ops/pallas/ec_pl.py:186

A and B carry the batch proof's MSMs; C is the serial step of the fast G1
MSM (ops/msm.py:g1_window_sums_fast, the KZG's MSM) and D the unsafe mixed
add behind bn254.point_madd_unsafe.  Each source notes what bounds it on
the H100 and what its design does about it.  The sources are compiled with
nvcc for sm_90a (one nvcc per source, all started together) and linked into
one shared library with a plain C interface, at first use, into
`_build/<hash of the sources>/` next to this package, and loaded with
ctypes.

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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    "point_scan_step": {
        "route": "cuda",
        "source": "eigen_zeth_tpu_torch/csrc/scan_step.cu",
        "replaces": "eigen_zeth_tpu/ops/pallas/ec_pl.py:242",
    },
    "point_madd": {
        "route": "cuda",
        "source": "eigen_zeth_tpu_torch/csrc/point_madd.cu",
        "replaces": "eigen_zeth_tpu/ops/pallas/ec_pl.py:186",
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

    Every source gets its own nvcc, all started together, and one link
    joins the objects.  Returns the library path; the ptxas report
    (registers, spills) sits beside it as ptxas.log."""
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
    nvcc = _nvcc()
    pid = os.getpid()
    jobs = []
    for src in sources:
        if src.suffix != ".cu":
            continue
        obj = out_dir / f"{src.stem}.{pid}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    logs = [proc.communicate()[0] for _, proc in jobs]
    (out_dir / "ptxas.log").write_text("".join(logs))
    failed = [log for (_, proc), log in zip(jobs, logs) if proc.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out_dir / f"libezt_kernels.{pid}.so"
    objs = [str(obj) for obj, _ in jobs]
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    os.replace(tmp, lib)
    for obj in objs:
        os.unlink(obj)
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
            lib.ezt_point_scan_step.argtypes = (
                [vp] * 11 + [ctypes.c_longlong, vp, ctypes.c_uint, vp, vp]
            )
            lib.ezt_point_scan_step.restype = ctypes.c_int
            lib.ezt_point_madd.argtypes = [vp] * 9 + [ctypes.c_longlong, vp, ctypes.c_uint, vp]
            lib.ezt_point_madd.restype = ctypes.c_int
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


def _check_masks(name: str, masks, like: torch.Tensor) -> None:
    """All (n,) int32, contiguous, on the limbs' device."""
    for t in masks:
        if t.device != like.device:
            raise ValueError(f"{name}: masks must lie on the limbs' device")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 masks, got {t.dtype}")
        if t.shape != like.shape[1:] or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous ({like.shape[1]},) masks, "
                             f"got {tuple(t.shape)}")


def _words(value: int) -> ctypes.Array:
    return (ctypes.c_uint32 * 8)(*((value >> (32 * i)) & 0xFFFFFFFF for i in range(8)))


def _launch(name: str, ctx, tensors, n: int, *extra) -> None:
    """Launch `ezt_<name>` over n elements on the current stream of the
    tensors' device and count it; raise if the card refuses the launch.
    Arguments: the tensors' pointers, n, the modulus words, n0, `extra`."""
    lib = _load()
    qw = _words(ctx.q)
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, "ezt_" + name)(
            *(t.data_ptr() for t in tensors), n, ctypes.cast(qw, ctypes.c_void_p), ctx.n0_32,
            *extra, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# kernel A: Montgomery multiply


def mont_mul(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b·R^{-1} mod ctx.q on (16, n) int32 limbs (canonical in and out)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(ctx, a, b)
    n = _check_limbs("mont_mul", (a, b))
    out = torch.empty_like(a)
    if n:
        _launch("mont_mul", ctx, (a, b, out), n)
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
    if n:
        _launch("point_add", ctx, tensors + outs, n)
    return outs


def point_add_plain(ctx, p, q):
    """Plain PyTorch version of kernel B: bn254.point_add over the plain
    field ops (no kernel launch)."""
    from . import bn254

    F = bn254.FqOps(ctx, plain=True)
    out = bn254.point_add(F, bn254.PointJ(*p), bn254.PointJ(*q))
    return tuple(out)


# ---------------------------------------------------------------------------
# kernel C: fused MSM scan step


def point_scan_step(ctx, acc, q_aff, sgn: torch.Tensor, flg: torch.Tensor):
    """One fused MSM phase-1 step on (16, n) int32 coordinate limbs.

    acc = (x, y, z) Jacobian, q_aff = (x, y) affine, sgn / flg (n,) int32
    masks (non-zero = set).  y' = -y where sgn; out = acc + (x, y', 1) by
    the unsafe mixed add, or (x, y', one) where flg; bad = 1 where the add
    hit H == 0 or Z1 == 0 outside a flag.  Returns (x3, y3, z3, bad), bad
    an (n,) int32 tensor of 0 / 1."""
    tensors = tuple(acc) + tuple(q_aff)
    if all(t.device.type == "cpu" for t in tensors + (sgn, flg)):
        return point_scan_step_plain(ctx, acc, q_aff, sgn, flg)
    n = _check_limbs("point_scan_step", tensors)
    _check_masks("point_scan_step", (sgn, flg), tensors[0])
    outs = tuple(torch.empty_like(tensors[0]) for _ in range(3))
    bad = torch.empty_like(sgn)
    if n:
        one = _words(ctx.R_mod)
        _launch("point_scan_step", ctx, tensors + (sgn, flg) + outs + (bad,), n,
                ctypes.cast(one, ctypes.c_void_p))
    return outs + (bad,)


def point_scan_step_plain(ctx, acc, q_aff, sgn: torch.Tensor, flg: torch.Tensor):
    """Plain PyTorch version of kernel C: sign select, bn254.point_madd_unsafe
    over the plain field ops, restart select (no kernel launch)."""
    from . import bn254

    F = bn254.FqOps(ctx, plain=True)
    qx, qy = q_aff
    negate, restart = sgn != 0, flg != 0
    qy2 = F.select(negate, F.neg(qy), qy)
    new, collide = bn254.point_madd_unsafe(F, bn254.PointJ(*acc), qx, qy2)
    one = F.one_like(qx)
    return (
        F.select(restart, qx, new.x),
        F.select(restart, qy2, new.y),
        F.select(restart, one, new.z),
        (collide & ~restart).to(torch.int32),
    )


# ---------------------------------------------------------------------------
# kernel D: unsafe mixed add


def point_madd(ctx, p, q_aff):
    """Unsafe mixed add p + (x, y, 1) on (16, n) int32 coordinate limbs.

    p = (x, y, z) Jacobian, q_aff = (x, y) affine.  Returns (x3, y3, z3,
    bad), bad an (n,) int32 tensor: 1 where H == 0 or Z1 == 0, and there
    the three coordinates mean nothing."""
    tensors = tuple(p) + tuple(q_aff)
    if all(t.device.type == "cpu" for t in tensors):
        return point_madd_plain(ctx, p, q_aff)
    n = _check_limbs("point_madd", tensors)
    outs = tuple(torch.empty_like(tensors[0]) for _ in range(3))
    bad = torch.empty_like(tensors[0][0])
    if n:
        _launch("point_madd", ctx, tensors + outs + (bad,), n)
    return outs + (bad,)


def point_madd_plain(ctx, p, q_aff):
    """Plain PyTorch version of kernel D: bn254.point_madd_unsafe over the
    plain field ops (no kernel launch)."""
    from . import bn254

    F = bn254.FqOps(ctx, plain=True)
    out, collide = bn254.point_madd_unsafe(F, bn254.PointJ(*p), *q_aff)
    return tuple(out) + (collide.to(torch.int32),)
