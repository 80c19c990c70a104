"""The hand-written CUDA kernels of the port: build, wrappers, plain versions.

Four kernels replace the four Pallas kernels of the JAX package, two more
entry points of A's and B's sources take over work that the JAX package
does with many launches of those kernels, and a fifth kernel hashes for the
STARK side, which the JAX package leaves to XLA and to its native host
hasher:

  A mont_mul         csrc/mont_mul.cu    eigen_zeth_tpu/ops/pallas/mont_pl.py:30
    mont_pow         csrc/mont_mul.cu    eigen_zeth_tpu/ops/bigint.py:342
  B point_add        csrc/point_add.cu   eigen_zeth_tpu/ops/pallas/ec_pl.py:118
    point_add_g2     csrc/point_add.cu   eigen_zeth_tpu/ops/bn254.py:206
  C point_scan_step  csrc/scan_step.cu   eigen_zeth_tpu/ops/pallas/ec_pl.py:242
  D point_madd       csrc/point_madd.cu  eigen_zeth_tpu/ops/pallas/ec_pl.py:186
  E poseidon2        csrc/poseidon2_gl.cu  eigen_zeth_tpu/ops/poseidon.py:431
    poseidon2_rows   csrc/poseidon2_gl_rows.cu  none (host numpy there:
                                            eigen_zeth_tpu/models/recursion.py:973)
  F poseidon_fr      csrc/poseidon2_fr.cuh eigen_zeth_tpu/ops/poseidon_fr.py:271
                     (its core; entries in poseidon2_fr.cu, _fr_perm.cu, _fr_tree.cu)
  G keccak256        csrc/keccak.cu      eigen_zeth_tpu/ops/keccak.py:122, :152

A and B carry the batch proof's MSMs; C is the serial step of the fast G1
MSM (ops/msm.py:g1_window_sums_fast, the KZG's MSM) and D the unsafe mixed
add behind bn254.point_madd_unsafe.  `mont_pow` is a whole power (Fermat
inversion) in one launch, a sliding window whose schedule `pow_schedule`
makes here; `point_add_g2` is B over Fq2, two lanes a point; both point adds
take an optional mask that passes one operand through (the select of the
MSM scans).  E is Poseidon2 over Goldilocks on a lazy-reduction field core, one
thread per state, with four entry points (`poseidon2_perm`,
`poseidon2_hash_rows`, `poseidon2_hash_two`, and `poseidon2_merkle_levels`,
a whole Merkle tree in one launch) that share one launch count;
ops/poseidon.py sends CUDA tensors to them and keeps the plain versions, and
every Merkle commit of the chunk STARKs and of the AIR prover runs through
them.  A fifth entry of E, `poseidon2_verifier_rows`
(csrc/poseidon2_gl_rows.cu, counted apart as "poseidon2_rows"), fills the
Poseidon2 columns of every permutation slot of the verifier AIR's trace in
place: rows that the JAX package builds in host numpy
(eigen_zeth_tpu/models/recursion.py:973), so it replaces no TPU kernel.  F
is Poseidon2 over BN254 Fr on its own lazy Montgomery core
(csrc/poseidon2_fr.cuh: values kept in ranges above r instead of reduced
after every operation, Shoup's product by the diagonal), one thread per
state, with three entry points (`poseidon_fr_perm`, `poseidon_fr_hash_rows`,
the leaf sponge over Goldilocks rows packed 3 to an Fr element, and
`poseidon_fr_merkle_levels`, a whole tree in one launch) that share one
launch count; it commits the wrap-profile attestation's Fr Merkle trees and
grinds its proof of work (ops/poseidon_fr.py keeps the plain versions).
G is the batched keccak256 of ops/keccak.py (the JAX package's device
Keccak, XLA code there): one thread per message, the 25 lanes in registers,
every block absorbed in one launch.  As in the JAX package, no path of the
node calls it; every Keccak of the node stays `keccak256_host`.
Each source notes what bounds it on the H100 and what its design does
about it (F's three entry points are three sources, poseidon2_fr.cu,
poseidon2_fr_perm.cu and poseidon2_fr_tree.cu, so that they compile side by
side).  The sources are compiled with nvcc for sm_90a (one nvcc per
source, all started together) and linked into one shared library with a
plain C interface, at first use, into `_build/<hash of the sources>/` next
to this package, and loaded with ctypes.  `csrc/imad_probe.cu` measures the
card's integer multiply-add rate and is no kernel of any path.

Each wrapper takes its plain PyTorch version only for a CPU tensor.  For a
CUDA tensor it launches the kernel or raises; nothing falls back.  Each
launch adds one to `LAUNCHES[name]`; a point add's launch with a mask also
adds one to `LAUNCHES[name + "_masked"]`; each of E's entry points adds one
to `LAUNCHES["poseidon2"]` (the verifier rows to `LAUNCHES["poseidon2_rows"]`),
each of F's to `LAUNCHES["poseidon_fr"]`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
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
    "mont_pow": {
        "route": "cuda",
        "source": "eigen_zeth_tpu_torch/csrc/mont_mul.cu",
        "replaces": "eigen_zeth_tpu/ops/bigint.py:342",
    },
    "point_add_g2": {
        "route": "cuda",
        "source": "eigen_zeth_tpu_torch/csrc/point_add.cu",
        "replaces": "eigen_zeth_tpu/ops/bn254.py:206",
    },
    "poseidon2": {
        "route": "cuda",
        "source": "eigen_zeth_tpu_torch/csrc/poseidon2_gl.cu",
        "replaces": "eigen_zeth_tpu/ops/poseidon.py:431",
    },
    "poseidon_fr": {
        "route": "cuda",
        # the core that the three entries' sources (poseidon2_fr.cu,
        # poseidon2_fr_perm.cu, poseidon2_fr_tree.cu) share
        "source": "eigen_zeth_tpu_torch/csrc/poseidon2_fr.cuh",
        "replaces": "eigen_zeth_tpu/ops/poseidon_fr.py:271",
    },
    "keccak256": {
        "route": "cuda",
        "source": "eigen_zeth_tpu_torch/csrc/keccak.cu",
        "replaces": "eigen_zeth_tpu/ops/keccak.py:122",
    },
    "poseidon2_rows": {
        "route": "cuda",
        "source": "eigen_zeth_tpu_torch/csrc/poseidon2_gl_rows.cu",
        # no TPU kernel: the JAX package builds these rows in host numpy
        "replaces": "eigen_zeth_tpu/models/recursion.py:973",
    },
}
# the point adds under a mask (the scans' select): the same entries, counted
# and timed as rows of their own
for _name in ("point_add", "point_add_g2"):
    KERNELS[_name + "_masked"] = KERNELS[_name]

LAUNCHES = {name: 0 for name in KERNELS}

_lock = threading.Lock()
_lib = None
_fns: dict = {}  # kernel name -> its C function, filled by _load


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


_VP, _LL, _UI, _CI = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_int
# the C entry `ezt_<name>` of each kernel; after the tensors' pointers: n, the
# modulus words, n0, extras, stream
SIGNATURES = {
    "mont_mul": [_VP] * 3 + [_LL, _VP, _UI, _VP],
    "mont_pow": [_VP] * 2 + [_LL, _VP, _UI, _VP, _VP, _VP],
    "point_add": [_VP] * 9 + [_LL, _VP, _UI, _VP, _CI, _VP],
    "point_add_g2": [_VP, _LL, _VP, _UI, _VP, _CI, _VP],
    "point_scan_step": [_VP] * 11 + [_LL, _VP, _UI, _VP, _VP],
    "point_madd": [_VP] * 9 + [_LL, _VP, _UI, _VP],
    # kernel E's entries: tensors, sizes and strides in words, the constants, the stream
    "poseidon2_perm": [_VP, _VP, _LL, _VP, _VP],
    "poseidon2_hash_rows": [_VP, _VP, _LL, _LL, _LL, _LL, _VP, _VP],
    "poseidon2_hash_two": [_VP, _LL, _VP, _LL, _VP, _LL, _VP, _VP],
    "poseidon2_merkle_levels": [_VP, _LL, _LL, _LL, _LL, _VP, _VP, _LL, _VP, _VP],
    # kernel F's entries: tensors, sizes and strides in words, [a Montgomery
    # capacity value], the modulus words, n0, the constants, the stream
    "poseidon_fr_perm": [_VP, _VP, _LL, _VP, _UI, _VP, _VP],
    "poseidon_fr_hash_rows": [_VP, _VP, _LL, _LL, _LL, _LL, _VP, _VP, _UI, _VP, _VP],
    "poseidon_fr_merkle_levels": [_VP, _LL, _VP, _VP, _VP, _VP, _UI, _VP, _VP],
    # kernel G: the padded lanes, n, blocks a message, the digests, the stream
    "keccak256": [_VP, _LL, _LL, _VP, _VP],
    # kernel E's verifier rows: the trace, its row stride and period, queries,
    # slots, the plan, the paths (host), their count, E's constants, the stream
    "poseidon2_verifier_rows": [_VP, _LL, _LL, _LL, _LL, _VP, _VP, _LL, _VP, _VP],
}


def bind(lib: ctypes.CDLL, names=tuple(SIGNATURES)) -> dict:
    """The C functions `ezt_<name>` of a built library, with their types."""
    fns = {}
    for name in names:
        fns[name] = getattr(lib, "ezt_" + name)
        fns[name].argtypes, fns[name].restype = SIGNATURES[name], _CI
    return fns


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fns = bind(lib)
            lib.ezt_imad_probe.argtypes = [_VP, _CI, _CI, _CI, _CI, _VP, _UI,
                                           ctypes.POINTER(_LL), _VP]
            lib.ezt_imad_probe.restype = _CI
            _fns.update(fns)  # all at once: a launch on another thread sees all or none
            _lib = lib
    return _lib


def _check_limbs(name: str, tensors) -> int:
    """All (16, n) int32, contiguous, on one CUDA device; returns n."""
    first = tensors[0]
    index, shape = first.get_device(), first.shape
    if index < 0:
        raise ValueError(f"{name}: operands must share one CUDA device")
    if len(shape) != 2 or shape[0] != 16:
        raise ValueError(f"{name}: expected (16, n) limbs, got {tuple(shape)}")
    for t in tensors:
        if t.get_device() != index:
            raise ValueError(f"{name}: operands must share one CUDA device")
        if t.dtype is not torch.int32:
            raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{name}: expected matching (16, n) limbs, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: limbs must be contiguous")
    return shape[1]


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


class _Consts:
    """What a launch needs of a MontCtx, made once per context: the modulus
    and R mod q as host word arrays (kept alive here) and their addresses."""

    def __init__(self, ctx):
        if ctx.q >> 255:
            raise ValueError("the CUDA field core needs a modulus below 2^255")
        self._keep = (_words(ctx.q), _words(ctx.R_mod))
        self.q, self.one = (ctypes.cast(w, ctypes.c_void_p) for w in self._keep)
        self.n0 = ctx.n0_32


def _consts(ctx) -> _Consts:
    c = getattr(ctx, "_kernel_consts", None)
    if c is None:
        c = ctx._kernel_consts = _Consts(ctx)
    return c


def _launch(name: str, ctx, pointers, device, n: int, *extra) -> None:
    """Launch `ezt_<name>` over n elements on the current stream of `device`
    and count it; raise if the card refuses the launch.  Arguments:
    `pointers`, n, the modulus words, n0, `extra`, the stream."""
    if not _fns:
        _load()
    fn, c = _fns[name], _consts(ctx)
    if device.index == torch.cuda.current_device():
        rc = fn(*pointers, n, c.q, c.n0, *extra, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*pointers, n, c.q, c.n0, *extra,
                    torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
    LAUNCHES[name] += 1


def _pointers(tensors):
    return [t.data_ptr() for t in tensors]


# ---------------------------------------------------------------------------
# kernel A: Montgomery multiply


def mont_mul(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b·R^{-1} mod ctx.q on (16, n) int32 limbs (canonical in and out)."""
    if not (a.is_cuda or b.is_cuda):
        return mont_mul_plain(ctx, a, b)
    n = _check_limbs("mont_mul", (a, b))
    out = torch.empty_like(a)
    if n:
        _launch("mont_mul", ctx, (a.data_ptr(), b.data_ptr(), out.data_ptr()), a.device, n)
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


POW_WINDOW = 4  # the sliding window's width, 4 or 5 (csrc/mont_mul.cu holds 16 odd powers)
POW_MAX_STEPS = 72  # csrc/mont_mul.cu: kPowMaxSteps; 256 bits in windows of 4: 65 steps at most
NO_PRODUCT = 0xFF


def pow_schedule(exponent: int, width: int = POW_WINDOW) -> list[tuple[int, int]]:
    """The sliding-window chain of a^exponent as (squarings, digit) pairs,
    top window first: r = a^digit for the first pair, then for each later
    one `squarings` squarings and a product by a^digit (digit 0: none, the
    exponent's trailing zeros).  Digits are odd and below 2^width; a window
    starts at a set bit and ends at the lowest set bit within `width` bits.
    e = 0; e = (e << squarings) + digit over the pairs rebuilds the
    exponent; 0 has no pair."""
    if not 0 <= exponent < 1 << 256:
        raise ValueError("mont_pow: the exponent must lie in [0, 2^256)")
    steps: list[tuple[int, int]] = []
    pos, pending = exponent.bit_length() - 1, 0
    while pos >= 0:
        if not exponent >> pos & 1:
            pending, pos = pending + 1, pos - 1
            continue
        low = max(pos - width + 1, 0)
        while not exponent >> low & 1:
            low += 1
        length = pos - low + 1
        steps.append((pending + length if steps else 0, exponent >> low & ((1 << length) - 1)))
        pending, pos = 0, low - 1
    if pending:
        steps.append((pending, 0))
    return steps


def pow_table(steps) -> int:
    """The odd powers a, a^3, ... that a schedule uses (its table's entries)."""
    return (max(d for _, d in steps) + 1) // 2 if steps else 0


def pow_chain(steps) -> tuple[int, int]:
    """(products, squarings) that `mont_pow`'s kernel runs for a schedule:
    the table's a^2 and its products a^3 = a·a^2, a^5 = a^3·a^2, ..., then
    every window's squarings and its product by a table entry."""
    table = pow_table(steps)
    products = max(table - 1, 0) + sum(1 for _, d in steps[1:] if d)
    squarings = (table > 1) + sum(sq for sq, _ in steps)
    return products, squarings


class PowSchedule(ctypes.Structure):
    """csrc/mont_mul.cu's PowSchedule: entry j of the table is a^(2j + 1)."""

    _fields_ = [("steps", ctypes.c_int32), ("table", ctypes.c_int32),
                ("squarings", ctypes.c_uint8 * POW_MAX_STEPS),
                ("entry", ctypes.c_uint8 * POW_MAX_STEPS)]


@functools.lru_cache(maxsize=64)
def pow_schedule_struct(exponent: int, width: int = POW_WINDOW) -> PowSchedule:
    """`pow_schedule` in the kernel's layout, made once per exponent."""
    if width not in (4, 5):  # 16 odd powers at most; 256 bits in at most 65 steps
        raise ValueError(f"mont_pow: the window's width must be 4 or 5, got {width}")
    steps = pow_schedule(exponent, width)
    s = PowSchedule(len(steps), max(pow_table(steps), 1))
    for k, (sq, d) in enumerate(steps):
        s.squarings[k], s.entry[k] = sq, (d - 1) // 2 if d else NO_PRODUCT
    return s


def mont_pow(ctx, a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent (Montgomery in and out) on (16, n) int32 limbs, for a host
    integer 0 <= exponent < 2^256: one launch for the whole sliding-window
    chain (`pow_schedule`).  a^0 = one for every a, so inv(0) = 0^(q-2) = 0."""
    if not a.is_cuda:
        return mont_pow_plain(ctx, a, exponent)
    return _launch_pow(ctx, a, pow_schedule_struct(exponent))


def _launch_pow(ctx, a: torch.Tensor, schedule: PowSchedule) -> torch.Tensor:
    """One launch of the power kernel on CUDA limbs a with a made schedule
    (scripts/tune_mont_pow.py hands it other widths)."""
    n = _check_limbs("mont_pow", (a,))
    out = torch.empty_like(a)
    if n:
        _launch("mont_pow", ctx, (a.data_ptr(), out.data_ptr()), a.device, n,
                ctypes.addressof(schedule), _consts(ctx).one)
    return out


def mont_pow_plain(ctx, a: torch.Tensor, exponent: int) -> torch.Tensor:
    """Plain PyTorch version of `mont_pow`: square and multiply, LSB first,
    every product `mont_mul_plain` (the JAX package's loop,
    eigen_zeth_tpu/ops/bigint.py:342)."""
    result = ctx.one_mont(a.shape[1:], a.device)
    base = a
    e = exponent
    while e:
        if e & 1:
            result = mont_mul_plain(ctx, result, base)
        e >>= 1
        if e:
            base = mont_mul_plain(ctx, base, base)
    return result


# ---------------------------------------------------------------------------
# kernel B: complete Jacobian add, G1 and G2, with the scans' select


def _launch_add(name: str, ctx, pointers, like: torch.Tensor, mask, keep: int) -> None:
    """Launch a point add over like.shape[1] elements, with or without a mask."""
    if mask is None:
        tail = (None, 0)
    else:
        if keep not in (0, 1):
            raise ValueError(f"{name}: keep must be 0 (pass p) or 1 (pass q)")
        _check_masks(name, (mask,), like)
        tail = (mask.data_ptr(), keep)
    _launch(name, ctx, pointers, like.device, like.shape[1], *tail)
    if mask is not None:
        LAUNCHES[name + "_masked"] += 1


def _select_kept(mask, kept, added):
    return tuple(torch.where(mask != 0, k, a) for k, a in zip(kept, added))


def point_add(ctx, p, q, mask: torch.Tensor | None = None, keep: int = 0):
    """Complete G1 Jacobian add on (16, n) int32 coordinate limbs.

    p, q: (x, y, z) tuples; returns (x3, y3, z3).  With an (n,) int32 mask,
    element i is p (keep = 0) or q (keep = 1), limbs unchanged, where
    mask[i] != 0, and the sum elsewhere."""
    tensors = tuple(p) + tuple(q)
    if not any(t.is_cuda for t in tensors):
        return point_add_plain(ctx, p, q, mask, keep)
    n = _check_limbs("point_add", tensors)
    outs = tuple(torch.empty_like(tensors[0]) for _ in range(3))
    if n:
        _launch_add("point_add", ctx, _pointers(tensors + outs), tensors[0], mask, keep)
    return outs


def point_add_plain(ctx, p, q, mask: torch.Tensor | None = None, keep: int = 0):
    """Plain PyTorch version of kernel B: bn254.point_add over the plain
    field ops, then the select (no kernel launch)."""
    from . import bn254

    F = bn254.FqOps(ctx, plain=True)
    out = tuple(bn254.point_add(F, bn254.PointJ(*p), bn254.PointJ(*q)))
    return out if mask is None else _select_kept(mask, (p, q)[keep], out)


def point_add_g2(ctx, p, q, mask: torch.Tensor | None = None, keep: int = 0):
    """Complete G2 Jacobian add.  p, q: (x, y, z) tuples of Fq2 coordinates,
    each a (c0, c1) pair of (16, n) int32 limbs over the base field `ctx`;
    returns the same structure.  The mask works as in `point_add`."""
    tensors = tuple(t for point in (p, q) for coord in point for t in coord)
    if not any(t.is_cuda for t in tensors):
        return point_add_g2_plain(ctx, p, q, mask, keep)
    if ctx.q >> 254:
        raise ValueError("point_add_g2: the two-lane Fq2 core needs a modulus below 2^254")
    n = _check_limbs("point_add_g2", tensors)
    outs = tuple(torch.empty_like(tensors[0]) for _ in range(6))
    if n:
        planes = (ctypes.c_void_p * 18)(*_pointers(tensors + outs))
        _launch_add("point_add_g2", ctx, (ctypes.cast(planes, ctypes.c_void_p),), tensors[0],
                    mask, keep)
    return tuple((outs[2 * c], outs[2 * c + 1]) for c in range(3))


def point_add_g2_plain(ctx, p, q, mask: torch.Tensor | None = None, keep: int = 0):
    """Plain PyTorch version of `point_add_g2`: bn254.point_add over the
    plain Fq2 ops, then the select (no kernel launch)."""
    from . import bn254

    F = bn254.Fq2Ops(ctx, plain=True)
    out = bn254.point_add(F, bn254.PointJ(*p), bn254.PointJ(*q))
    if mask is None:
        return tuple(out)
    kept = (p, q)[keep]
    return tuple(_select_kept(mask, k, o) for k, o in zip(kept, out))


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
    if not any(t.is_cuda for t in tensors + (sgn, flg)):
        return point_scan_step_plain(ctx, acc, q_aff, sgn, flg)
    n = _check_limbs("point_scan_step", tensors)
    _check_masks("point_scan_step", (sgn, flg), tensors[0])
    outs = tuple(torch.empty_like(tensors[0]) for _ in range(3))
    bad = torch.empty_like(sgn)
    if n:
        _launch("point_scan_step", ctx, _pointers(tensors + (sgn, flg) + outs + (bad,)),
                tensors[0].device, n, _consts(ctx).one)
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
    if not any(t.is_cuda for t in tensors):
        return point_madd_plain(ctx, p, q_aff)
    n = _check_limbs("point_madd", tensors)
    outs = tuple(torch.empty_like(tensors[0]) for _ in range(3))
    bad = torch.empty_like(tensors[0][0])
    if n:
        _launch("point_madd", ctx, _pointers(tensors + outs + (bad,)), tensors[0].device, n)
    return outs + (bad,)


def point_madd_plain(ctx, p, q_aff):
    """Plain PyTorch version of kernel D: bn254.point_madd_unsafe over the
    plain field ops (no kernel launch)."""
    from . import bn254

    F = bn254.FqOps(ctx, plain=True)
    out, collide = bn254.point_madd_unsafe(F, bn254.PointJ(*p), *q_aff)
    return tuple(out) + (collide.to(torch.int32),)


# ---------------------------------------------------------------------------
# kernel E: Poseidon2 over Goldilocks (the plain versions are in ops/poseidon.py)

_poseidon_consts = None  # (host word array kept alive, its address)


def poseidon2_const_words() -> list[int]:
    """The instance's constants as csrc/poseidon2_gl.cuh's `Consts`, in the
    order the schedule adds them, each round's riding on the linear layer
    before it: round 0's; after each full round the next round's (lane 0's
    of the first partial round after the fourth, zeros after the last);
    lane 0's of partial rounds 2..22; the full round after the partial
    rounds; the internal diagonal.  153 words."""
    from . import poseidon

    rc = poseidon.round_constants()
    full = [r for r in range(poseidon.N_ROUNDS) if poseidon._is_full_round(r)]
    partial = [r for r in range(poseidon.N_ROUNDS) if r not in full]
    width = poseidon.WIDTH
    words = list(rc[full[0]])
    for r in full:
        if r + 1 in full:
            words += rc[r + 1]
        elif r + 1 in partial:
            words += [rc[r + 1][0]] + [0] * (width - 1)
        else:
            words += [0] * width
    words += [rc[r][0] for r in partial[1:]]
    words += rc[partial[-1] + 1]
    return words + poseidon.internal_diag()


def _poseidon2_consts() -> int:
    """The address of `poseidon2_const_words()` as host words, made once."""
    global _poseidon_consts
    if _poseidon_consts is None:
        words = poseidon2_const_words()
        arr = (ctypes.c_uint64 * len(words))(*words)
        _poseidon_consts = (arr, ctypes.cast(arr, ctypes.c_void_p).value)
    return _poseidon_consts[1]


def _launch_poseidon2(entry: str, index: int, *args, count: str = "poseidon2") -> None:
    """Launch `ezt_poseidon2_<entry>` on the current stream of CUDA device
    `index` and count it under `count`; raise if the card refuses the
    launch.  The device and the raw stream come from PyTorch's C accessors
    (what its own compiled kernels use): a plain call each, where the
    torch.cuda functions build Python objects."""
    if not _fns:
        _load()
    fn = _fns["poseidon2_" + entry]
    if index == torch._C._cuda_getDevice():
        rc = fn(*args, _poseidon2_consts(), torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, _poseidon2_consts(), torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"poseidon2_{entry}: kernel launch failed with cudaError {rc}")
    LAUNCHES[count] += 1


def _check_words(name: str, t: torch.Tensor, width: int | None = None) -> int:
    """A CUDA int64 tensor of (..., width) field words, or raise; returns its
    device index."""
    index = t.get_device()
    if index < 0:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype is not torch.int64:
        raise TypeError(f"{name}: expected int64 field words, got {t.dtype}")
    shape = t.shape
    if not shape or (width is not None and shape[-1] != width):
        raise ValueError(f"{name}: expected (..., {width or 'k'}) words, got {tuple(shape)}")
    return index


def _digest_rows(t: torch.Tensor) -> torch.Tensor:
    """(..., 4) digests as (n, 4) rows of contiguous words: a view where the
    strides allow one (every other row of a Merkle level), else a copy."""
    rows = t.reshape(-1, 4) if t.dim() != 2 else t
    return rows if rows.stride(1) == 1 else rows.contiguous()


def poseidon2_perm(state: torch.Tensor) -> torch.Tensor:
    """Kernel E on (..., 12) canonical states of a CUDA int64 tensor."""
    index = _check_words("poseidon2_perm", state, 12)
    rows = state.reshape(-1, 12).contiguous()
    out = torch.empty_like(rows)
    if rows.shape[0]:
        _launch_poseidon2("perm", index, rows.data_ptr(), out.data_ptr(), rows.shape[0])
    return out.reshape(state.shape)


def poseidon2_hash_rows(elements: torch.Tensor) -> torch.Tensor:
    """Kernel E's sponge over the last axis: (..., k) -> (..., 4) digests on
    a CUDA int64 tensor of canonical words, any k >= 0.  A 2-D input is read
    through its strides, so a transposed (column-major) matrix is not copied."""
    index = _check_words("poseidon2_hash_rows", elements)
    k = elements.shape[-1]
    rows = elements if elements.dim() == 2 else elements.reshape(math.prod(elements.shape[:-1]), k)
    n = rows.shape[0]
    out = rows.new_empty((n, 4))
    if n:
        row_stride, col_stride = rows.stride()
        _launch_poseidon2("hash_rows", index, rows.data_ptr(), out.data_ptr(), n, k,
                          row_stride, col_stride)
    return out if elements.dim() == 2 else out.reshape(elements.shape[:-1] + (4,))


def poseidon2_hash_two(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Kernel E's 2-to-1 compression: (..., 4) x (..., 4) -> (..., 4) on CUDA
    int64 tensors of canonical words.  Strided digests (every other row of a
    Merkle level) are read where they lie."""
    index = _check_words("poseidon2_hash_two", left, 4)
    if _check_words("poseidon2_hash_two", right, 4) != index or left.shape != right.shape:
        raise ValueError("poseidon2_hash_two: operands must share shape and device, got "
                         f"{tuple(left.shape)} on {left.device} and {tuple(right.shape)} "
                         f"on {right.device}")
    lrows, rrows = _digest_rows(left), _digest_rows(right)
    n = lrows.shape[0]
    out = lrows.new_empty((n, 4))
    if n:
        _launch_poseidon2("hash_two", index, lrows.data_ptr(), lrows.stride(0),
                          rrows.data_ptr(), rrows.stride(0), out.data_ptr(), n)
    return out if left.dim() == 2 else out.reshape(left.shape)


def poseidon2_merkle_levels(level: torch.Tensor) -> list[torch.Tensor]:
    """Kernel E's tree entry: every Merkle level above (..., n, 4) digests
    of a CUDA int64 tensor (n a power of two), a whole tree in one launch.
    Returns [(..., n / 2, 4), ..., (..., 1, 4)], each contiguous, and no
    level (no launch) for n = 1.  Digests must be contiguous words; the rows
    and the leading axes may have any strides."""
    index = _check_words("poseidon2_merkle_levels", level, 4)
    shape = level.shape
    if len(shape) < 2:
        raise ValueError(f"poseidon2_merkle_levels: expected (..., n, 4) digests, got {tuple(shape)}")
    n = shape[-2]
    if n < 1 or n & (n - 1):
        raise ValueError(f"poseidon2_merkle_levels: {n} digests is not a power of two")
    levels = n.bit_length() - 1
    rows = level.reshape(-1, n, 4) if len(shape) != 3 else level
    if rows.stride(2) != 1:
        rows = rows.contiguous()
    trees = rows.shape[0]
    outs = [torch.empty(shape[:-2] + (n >> j, 4), dtype=torch.int64, device=level.device)
            for j in range(1, levels + 1)]
    if trees and levels:
        per_tree = max(1, n >> 9)  # a ticket per pair of 256-node groups and level
        tickets = torch.zeros(trees * per_tree, dtype=torch.int32, device=level.device)
        ptrs = (ctypes.c_void_p * levels)(*(t.data_ptr() for t in outs))
        _launch_poseidon2("merkle_levels", index, rows.data_ptr(), rows.stride(0),
                          rows.stride(1), n, trees, ctypes.cast(ptrs, ctypes.c_void_p),
                          tickets.data_ptr(), per_tree)
    return outs


ROWS_COLS = 48  # csrc/poseidon2_gl_rows.cuh: a slot row's state, t^2, t^4, t^6
ROWS_PLAN_WORDS = 17  # kPlanWords: a plan entry's input state, sibling, bit
ROWS_MAX_CHAINS = 64  # csrc/poseidon2_gl_rows.cu: kMaxChains


def poseidon2_verifier_rows(trace: torch.Tensor, period: int, plan: torch.Tensor,
                            chains) -> None:
    """Kernel E's verifier-rows entry: every Poseidon2 slot of the verifier
    AIR's trace, filled in place.  trace: a contiguous (Q·period, C) CUDA
    int64 tensor; slot j of query q starts at row q·period + 32·j, and its
    32 rows get columns 0..47 (state, t^2, t^4, t^6).  plan: a
    contiguous (Q, S, 17) int64 tensor on the same device, per query and
    slot the input state (12 words), the sibling (4) and the bit (0 or 1);
    chains: (first slot, depth) of each Merkle path, whose later slots'
    inputs the kernel derives (and writes into `plan`).  Counted under
    "poseidon2_rows"; the plain version is models/recursion.py's
    `_fill_perm_rows_plain`."""
    index = _check_words("poseidon2_verifier_rows", trace)
    if _check_words("poseidon2_verifier_rows", plan, ROWS_PLAN_WORDS) != index:
        raise ValueError("poseidon2_verifier_rows: the plan must lie on the trace's device")
    if trace.dim() != 2 or plan.dim() != 3 or not (trace.is_contiguous() and plan.is_contiguous()):
        raise ValueError(f"poseidon2_verifier_rows: expected a contiguous (n, C) trace and "
                         f"(Q, S, 17) plan, got {tuple(trace.shape)} and {tuple(plan.shape)}")
    queries, slots, _ = plan.shape
    rows, width = trace.shape
    if rows != queries * period or 32 * slots > period or width < ROWS_COLS:
        raise ValueError(f"poseidon2_verifier_rows: {slots} slots of {queries} periods of "
                         f"{period} rows do not fit a {rows} x {width} trace")
    chains = [(int(first), int(depth)) for first, depth in chains]
    if len(chains) > ROWS_MAX_CHAINS or any(
            first < 0 or depth < 0 or first + depth >= slots for first, depth in chains):
        raise ValueError(f"poseidon2_verifier_rows: paths {chains} do not fit {slots} slots")
    table = (ctypes.c_longlong * max(1, 2 * len(chains)))(*(v for c in chains for v in c))
    if queries and slots:
        _launch_poseidon2("verifier_rows", index, trace.data_ptr(), width, period, queries,
                          slots, plan.data_ptr(), ctypes.cast(table, ctypes.c_void_p),
                          len(chains), count="poseidon2_rows")


# ---------------------------------------------------------------------------
# kernel F: Poseidon2 over BN254 Fr (the plain versions are in ops/poseidon_fr.py)

_fr_consts = None  # (host word arrays kept alive, the constants' address)
FR_TREE_THREADS = 128  # csrc/poseidon2_fr_launch.cuh's block: a tree's node groups


def poseidon_fr_const_words() -> list[int]:
    """csrc/poseidon2_fr.cuh's `Consts` as 32-bit words, 8 a value: the
    full rounds' constants (8 x 12), the partial rounds' (68) and the
    diagonal (12) in Montgomery form, then R^2 mod r (the Montgomery form
    of R: a product by it takes a regular value into Montgomery form), then
    the diagonal in regular form (12) and its Shoup quotients
    floor(mu_i·2^256 / r) (12)."""
    from . import bn254
    from . import poseidon_fr as pfr

    ctx = bn254.fr()
    rc = pfr.round_constants()
    full = [v for r in range(pfr.N_ROUNDS) if pfr._is_full_round(r) for v in rc[r]]
    part = [rc[r][0] for r in range(pfr.N_ROUNDS) if not pfr._is_full_round(r)]
    words = []
    diag = pfr.internal_diag()
    for m in ([v * ctx.R_mod % ctx.q for v in full + part + diag] + [ctx.R2_mod] + diag
              + [(v << 256) // ctx.q for v in diag]):
        words += [(m >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    return words


def _poseidon_fr_consts():
    global _fr_consts
    if _fr_consts is None:
        from . import bn254

        words = poseidon_fr_const_words()
        arr = (ctypes.c_uint32 * len(words))(*words)
        _fr_consts = (arr, ctypes.cast(arr, ctypes.c_void_p).value, _consts(bn254.fr()))
    return _fr_consts


def _mont_words(value: int) -> ctypes.Array:
    from . import bn254

    ctx = bn254.fr()
    return _words(value % ctx.q * ctx.R_mod % ctx.q)


def _launch_poseidon_fr(entry: str, index: int, *args) -> None:
    """Launch `ezt_poseidon_fr_<entry>` on the current stream of CUDA
    device `index` and count it under "poseidon_fr"; raise if the card
    refuses the launch."""
    if not _fns:
        _load()
    fn = _fns["poseidon_fr_" + entry]
    _, consts, c = _poseidon_fr_consts()
    tail = (c.q, c.n0, consts)
    if index == torch._C._cuda_getDevice():
        rc = fn(*args, *tail, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, *tail, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"poseidon_fr_{entry}: kernel launch failed with cudaError {rc}")
    LAUNCHES["poseidon_fr"] += 1


def poseidon_fr_perm(state: torch.Tensor) -> torch.Tensor:
    """Kernel F on (..., 12, 4) words of canonical Fr states (CUDA int64)."""
    index = _check_words("poseidon_fr_perm", state, 4)
    if state.dim() < 2 or state.shape[-2] != 12:
        raise ValueError(f"poseidon_fr_perm: expected (..., 12, 4) words, got {tuple(state.shape)}")
    rows = state.reshape(-1, 12, 4).contiguous()
    out = torch.empty_like(rows)
    if rows.shape[0]:
        _launch_poseidon_fr("perm", index, rows.data_ptr(), out.data_ptr(), rows.shape[0])
    return out.reshape(state.shape)


def poseidon_fr_hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """Kernel F's leaf sponge: (n, k) canonical Goldilocks words (a CUDA
    int64 tensor, read through its strides) -> (n, 4) words of the digests
    `hash_elements_host(pack_gl_host(row), "leaf")`."""
    from . import poseidon_fr as pfr

    index = _check_words("poseidon_fr_hash_rows", rows)
    if rows.dim() != 2:
        raise ValueError(f"poseidon_fr_hash_rows: expected (n, k) rows, got {tuple(rows.shape)}")
    n, k = rows.shape
    out = rows.new_empty((n, 4))
    if n:
        cap = _mont_words(pfr.sponge_capacity("leaf", -(-k // pfr.GL_PACK)))
        row_stride, col_stride = rows.stride()
        _launch_poseidon_fr("hash_rows", index, rows.data_ptr(), out.data_ptr(), n, k,
                            row_stride, col_stride, ctypes.cast(cap, ctypes.c_void_p))
    return out


def poseidon_fr_merkle_levels(digests: torch.Tensor) -> list[torch.Tensor]:
    """Kernel F's tree entry: every level above (n, 4) leaf digests (a CUDA
    int64 tensor, n a power of two) in one launch: [(n/2, 4), ..., (1, 4)];
    no level (no launch) for n = 1."""
    from . import poseidon_fr as pfr

    index = _check_words("poseidon_fr_merkle_levels", digests, 4)
    if digests.dim() != 2:
        raise ValueError("poseidon_fr_merkle_levels: expected (n, 4) digests, got "
                         f"{tuple(digests.shape)}")
    n = digests.shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError(f"poseidon_fr_merkle_levels: {n} digests is not a power of two")
    levels = n.bit_length() - 1
    outs = [torch.empty((n >> j, 4), dtype=torch.int64, device=digests.device)
            for j in range(1, levels + 1)]
    if levels:
        leaves = digests.contiguous()
        tickets = torch.zeros(max(1, n // (2 * FR_TREE_THREADS)), dtype=torch.int32,
                              device=digests.device)
        ptrs = (ctypes.c_void_p * levels)(*(t.data_ptr() for t in outs))
        cap = _mont_words(pfr._sha_to_fr("ezt-pfr-sponge/node"))
        _launch_poseidon_fr("merkle_levels", index, leaves.data_ptr(), n,
                            ctypes.cast(ptrs, ctypes.c_void_p), tickets.data_ptr(),
                            ctypes.cast(cap, ctypes.c_void_p))
    return outs


# ---------------------------------------------------------------------------
# kernel G: batched keccak256 (the plain version is in ops/keccak.py)


def keccak256_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """Kernel G on padded messages: lanes (nblocks·17, n) int64 on a CUDA
    device, lane l of block b of message i at [b·17 + l, i] -> the digests'
    four lanes (4, n), lane-major."""
    index = lanes.get_device()
    if index < 0:
        raise ValueError(f"keccak256: expected a CUDA tensor, got one on {lanes.device}")
    if lanes.dtype is not torch.int64:
        raise TypeError(f"keccak256: expected int64 lanes, got {lanes.dtype}")
    if lanes.dim() != 2 or lanes.shape[0] == 0 or lanes.shape[0] % 17:
        raise ValueError(f"keccak256: expected (blocks x 17, n) lanes, got {tuple(lanes.shape)}")
    lanes = lanes.contiguous()
    n = lanes.shape[1]
    out = lanes.new_empty((4, n))
    if n:
        if not _fns:
            _load()
        with torch.cuda.device(index):
            rc = _fns["keccak256"](lanes.data_ptr(), n, lanes.shape[0] // 17, out.data_ptr(),
                                   torch._C._cuda_getCurrentRawStream(index))
        if rc != 0:
            raise RuntimeError(f"keccak256: kernel launch failed with cudaError {rc}")
        LAUNCHES["keccak256"] += 1
    return out


# ---------------------------------------------------------------------------
# the integer-rate probe (a measurement, on no path)


def imad_probe(device, mode: int, blocks: int, threads: int = 256, iters: int = 4096):
    """Launch csrc/imad_probe.cu on `device`: mode 0 times the bare wide
    multiply-add, mode 1 chains of Montgomery products over Fq.  Returns (the
    multiply-adds the launch executes, its output tensor); the caller times
    it."""
    from . import bn254

    lib = _load()
    c = _consts(bn254.fq())
    out = torch.empty(blocks * threads, dtype=torch.int32, device=device)
    mads = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        rc = lib.ezt_imad_probe(out.data_ptr(), mode, blocks, threads, iters, c.q, c.n0,
                                ctypes.byref(mads), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"imad_probe: kernel launch failed with cudaError {rc}")
    return mads.value * blocks * threads, out
