"""Multi-scalar multiplication (Pippenger) over BN254 — port of the
complete-add schedule of eigen_zeth_tpu/ops/msm.py.

Per window w (digits d_i = bits [Cw, Cw+C) of each scalar), all W windows
batched on one axis:
  1. sort points by digit (stable)
  2. inclusive segmented scan with the EC group op; segment boundaries
     where the sorted digit changes, so each segment's last value is that
     bucket's point sum.  Every scan runs on the blocked O(N) schedule:
     SERIAL steps along each lane, then a short scan over the lanes
  3. one scatter of the segment-end sums into the bucket table
  4. Σ_b b·B_b as the total of the reverse (suffix) scan of the buckets
The window sums come back to the host affine, and the Horner combine
Σ_w 2^(Cw)·S_w runs on python ints.

Every group op is `ECGroup.add`: the G1 add goes to kernel B (ops/kernels.py)
at every size, and the G2 add is the generic Jacobian add over Fq2, whose
Fq products go to kernel A.  The MSM result is one point whatever the order
of equal digits, so the sort order may differ from the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bn254, kernels
from .bn254 import PointJ, from_affine, point_add, to_affine

C = 8  # window bits: 32 windows of 256 buckets over 254-bit scalars
SERIAL = 32  # serial steps per lane of the blocked scans


def scalar_limbs(scalars, nbits: int = 254) -> np.ndarray:
    """Host ints -> (N, K) uint32 little-endian limbs, K = ceil(nbits/32)."""
    nlimbs = (nbits + 31) // 32
    buf = b"".join(int(s).to_bytes(nlimbs * 4, "little") for s in scalars)
    return np.frombuffer(buf, dtype=np.uint32).reshape(len(scalars), nlimbs).copy()


def scalar_digits(scalars, c: int = C, nbits: int = 254) -> np.ndarray:
    """Host ints -> (W, N) uint32 window digits (numpy)."""
    limbs = scalar_limbs(scalars, nbits).astype(np.uint64)
    n = limbs.shape[0]
    padded = np.concatenate([limbs, np.zeros((n, 1), np.uint64)], axis=1)
    n_windows = (nbits + c - 1) // c
    mask = np.uint64((1 << c) - 1)
    out = np.empty((n_windows, n), dtype=np.uint32)
    for w in range(n_windows):
        limb, r = divmod(c * w, 32)
        vals = padded[:, limb] >> np.uint64(r)
        if r:
            vals |= padded[:, limb + 1] << np.uint64(32 - r)
        out[w] = (vals & mask).astype(np.uint32)
    return out


def digits_from_limbs(limbs: torch.Tensor, c: int = C, nbits: int = 254) -> torch.Tensor:
    """Device: (N, K) int64 tensor of 32-bit limbs -> (W, N) int64 digits."""
    n = limbs.shape[0]
    padded = torch.cat([limbs, torch.zeros_like(limbs[:, :1])], dim=1)
    mask = (1 << c) - 1
    rows = []
    for w in range((nbits + c - 1) // c):
        limb, r = divmod(c * w, 32)
        vals = padded[:, limb] >> r
        if r:
            vals = vals | (padded[:, limb + 1] << (32 - r))
        rows.append(vals & mask)
    return torch.stack(rows, dim=0) if rows else torch.zeros((0, n), dtype=torch.int64)


def _tmap(fn, *trees):
    """Map over the tensor leaves of PointJ / tuple trees."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    mapped = [_tmap(fn, *parts) for parts in zip(*trees)]
    return type(t0)(*mapped) if isinstance(t0, PointJ) else tuple(mapped)


def _first_leaf(tree) -> torch.Tensor:
    while not isinstance(tree, torch.Tensor):
        tree = tree[0]
    return tree


class ECGroup:
    """The EC group op as the MSM machinery sees it (elements: PointJ)."""

    def __init__(self, F):
        self.F = F
        self._is_g1 = isinstance(F, bn254.FqOps)

    def add(self, a: PointJ, b: PointJ) -> PointJ:
        shape = _first_leaf(a).shape
        if _first_leaf(b).shape != shape:
            shape = torch.broadcast_shapes(shape, _first_leaf(b).shape)
            a, b = (_tmap(lambda t: t.expand(shape), x) for x in (a, b))
        if not self._is_g1:
            return point_add(self.F, a, b)
        flat = lambda t: t.reshape(16, -1).contiguous()  # noqa: E731
        out = kernels.point_add(self.F.ctx, tuple(map(flat, a)), tuple(map(flat, b)))
        return PointJ(*(t.reshape(shape) for t in out))

    def select(self, pred, a, b):
        return _tmap(lambda x, y: torch.where(pred, x, y), a, b)


def _hs_scan(G, pts, flags):
    """Inclusive segmented Hillis-Steele scan along the last axis; flags
    marks segment starts.  ceil(log2(n)) group ops."""
    leaf = _first_leaf(pts)
    n = leaf.shape[-1]
    idx = torch.arange(n, device=leaf.device)
    f = flags.reshape((1,) * (leaf.ndim - flags.ndim) + tuple(flags.shape))
    v = pts
    for d in range(max((n - 1).bit_length(), 0)):
        s = 1 << d
        sh_v = _tmap(lambda l: torch.roll(l, s, dims=-1), v)
        valid = idx >= s
        v = G.select(valid & ~f, G.add(sh_v, v), v)
        f = f | (valid & torch.roll(f, s, dims=-1))
    return v


def _blocked_seg_scan(G, pts, flags):
    """O(N) two-phase segmented inclusive scan along the last axis:
      phase 1  N viewed as (C lanes x S serial): lane-local segmented sums,
               one full-width group op per serial step
      phase 2  lane tails combine with a small segmented scan over C
      phase 3  one masked add folds each lane's inflow into its head run
    flags: one rank less than the leaves (broadcasts in selects)."""
    n = flags.shape[-1]
    S = SERIAL
    while n % S:
        S //= 2
    C = n // S
    resh = lambda l: l.reshape(l.shape[:-1] + (C, S))  # noqa: E731
    pts_r = _tmap(resh, pts)
    flags_r = resh(flags)
    lane_start = flags_r.clone()
    lane_start[..., 0] = True

    acc = _tmap(lambda l: torch.zeros_like(l[..., 0]), pts_r)
    outs = []
    for i in range(S):
        val = _tmap(lambda l: l[..., i], pts_r)
        acc = G.select(lane_start[..., i], val, G.add(acc, val))
        outs.append(acc)
    scanned = _tmap(lambda *ls: torch.stack(ls, dim=-1), *outs)

    tails = _tmap(lambda l: l[..., -1], scanned)
    lane_scan = _hs_scan(G, tails, flags_r.any(dim=-1))
    shifted = _tmap(lambda l: torch.roll(l, 1, dims=-1), lane_scan)
    connected = (torch.arange(C, device=flags.device) > 0) & ~flags_r[..., 0]
    inflow = G.select(connected, shifted, _tmap(torch.zeros_like, shifted))

    head = torch.cumsum(flags_r.to(torch.int32), dim=-1) == 0
    inflow_b = _tmap(lambda l: l[..., None].expand(l.shape + (S,)), inflow)
    fixed = G.select(head, G.add(scanned, inflow_b), scanned)
    return _tmap(lambda l: l.reshape(l.shape[:-2] + (n,)), fixed)


def _blocked_scan(G, pts, reverse: bool = False):
    """O(N) plain inclusive scan along the last axis (one segment)."""
    if reverse:
        pts = _tmap(lambda l: torch.flip(l, dims=(-1,)), pts)
    leaf = _first_leaf(pts)
    flags = torch.zeros(leaf.shape[1:], dtype=torch.bool, device=leaf.device)
    out = _blocked_seg_scan(G, pts, flags)
    if reverse:
        out = _tmap(lambda l: torch.flip(l, dims=(-1,)), out)
    return out


def msm_window_sums(G, points, digits: torch.Tensor):
    """Per-window bucket-aggregated sums S_w = Σ_b b·B_b, all windows at
    once; points (16, N) leaves, digits (W, N) -> leaves (..., W)."""
    nbuckets = 1 << C
    W = digits.shape[0]
    d_sorted, order = torch.sort(digits, dim=-1, stable=True)
    pts = _tmap(lambda leaf: leaf[:, order], points)  # (16, W, N)

    first = torch.ones((W, 1), dtype=torch.bool, device=digits.device)
    flags = torch.cat([first, d_sorted[:, 1:] != d_sorted[:, :-1]], dim=-1)
    scanned = _blocked_seg_scan(G, pts, flags)

    # segment ends land in their bucket; everything else in a dummy slot
    ends = torch.cat([flags[:, 1:], first], dim=-1)
    target = torch.where(ends, d_sorted, torch.full_like(d_sorted, nbuckets + 1))
    w_idx = torch.arange(W, device=digits.device)[:, None]

    def scatter(leaf):
        # slots: bucket 0 (dropped), buckets 1..2^c-1, one identity that pads
        # the bucket axis to 2^c (a trailing identity changes no suffix sum)
        # and the dummy slot
        buckets = torch.zeros(leaf.shape[:-2] + (W, nbuckets + 2), dtype=leaf.dtype,
                              device=leaf.device)
        buckets[..., w_idx, target] = leaf
        return buckets[..., 1 : nbuckets + 1]

    suffix = _blocked_scan(G, _tmap(scatter, scanned), reverse=True)
    # Σ_b b·B_b is the total of the suffix sums: the last element of their scan
    return _tmap(lambda l: l[..., -1], _blocked_scan(G, suffix))


def _host_horner(windows, fq2: bool = False):
    """Host combine Σ_w 2^(Cw)·S_w (python ints)."""
    Fh = bn254.HOST_FQ2 if fq2 else bn254.HOST_FQ
    acc = None
    for S_w in reversed(windows):
        for _ in range(C):
            acc = bn254.h_ec_add(acc, acc, Fh)
        acc = bn254.h_ec_add(acc, S_w, Fh)
    return acc


def _g1_device_points(points_int, device) -> PointJ:
    F = bn254.FqOps()
    xs = F.ctx.from_int([p[0] if p is not None else 0 for p in points_int], device)
    ys = F.ctx.from_int([p[1] if p is not None else 0 for p in points_int], device)
    inf = torch.tensor([p is None for p in points_int], device=device)
    return from_affine(F, xs, ys, is_inf=inf)


def _g2_device_points(points_int, device) -> PointJ:
    F = bn254.Fq2Ops()
    ctx = F.fq.ctx

    def coord(i, j):
        return ctx.from_int([p[i][j] if p is not None else 0 for p in points_int], device)

    inf = torch.tensor([p is None for p in points_int], device=device)
    return from_affine(F, (coord(0, 0), coord(0, 1)), (coord(1, 0), coord(1, 1)), is_inf=inf)


def _pad(points_int, scalars):
    """Pad to a multiple of SERIAL with infinities (digit 0, bucket 0), so
    the blocked scans run full serial lanes."""
    pad = (-len(points_int)) % SERIAL
    return list(points_int) + [None] * pad, list(scalars) + [0] * pad


def _window_sums(F, pts, scalars, device):
    """Affine window sums on the host; pts come padded like scalars."""
    limbs = torch.from_numpy(scalar_limbs(scalars).astype(np.int64)).to(device)
    S = msm_window_sums(ECGroup(F), pts, digits_from_limbs(limbs))
    ax, ay = to_affine(F, S)
    return F.to_int(ax), F.to_int(ay), F.is_zero(S.z).cpu().numpy()


def msm_g1(points_int, scalars, *, device):
    """Σ s_i·P_i on G1 on `device`; host ints in, affine host ints out
    (None = infinity)."""
    F = bn254.FqOps()
    points_int, scalars = _pad(points_int, scalars)
    xs, ys, inf = _window_sums(F, _g1_device_points(points_int, device), scalars, device)
    windows = [None if inf[w] else (int(xs[w]), int(ys[w])) for w in range(len(inf))]
    return _host_horner(windows)


def msm_g2(points_int, scalars, *, device):
    """Σ s_i·P_i on G2 on `device`; affine ((x0, x1), (y0, y1)) out."""
    F = bn254.Fq2Ops()
    points_int, scalars = _pad(points_int, scalars)
    (x0, x1), (y0, y1), inf = _window_sums(F, _g2_device_points(points_int, device), scalars,
                                           device)
    windows = [
        None if inf[w] else ((int(x0[w]), int(x1[w])), (int(y0[w]), int(y1[w])))
        for w in range(len(inf))
    ]
    return _host_horner(windows, fq2=True)
