"""Multi-scalar multiplication (Pippenger) over BN254 — port of
eigen_zeth_tpu/ops/msm.py: the complete-add schedule (G1 and G2) and the
fast G1 schedule with its fixed-base table.

Complete-add schedule (`msm_window_sums`, `msm_g1`, `msm_g2`).  Per window
w (digits d_i = bits [cw, cw+c) of each scalar), all W windows batched on
one axis:
  1. sort points by digit (stable)
  2. inclusive segmented scan with the EC group op; segment boundaries
     where the sorted digit changes, so each segment's last value is that
     bucket's point sum.  Every scan runs on the blocked O(N) schedule:
     `serial` steps along each lane, then a short scan over the lanes
  3. one scatter of the segment-end sums into the bucket table
  4. Σ_b b·B_b as the total of the reverse (suffix) scan of the buckets
Every group op of the scans is `ECGroup.add_select`, an add whose select
(pass one operand through where a mask is set) runs inside the kernel: the
G1 add goes to kernel B (ops/kernels.py) at every size and the G2 add to
the same kernel over Fq2, one launch per add.

Fast G1 schedule (`g1_window_sums_fast`, `msm_g1_fast`, `msm_g1_device`,
`msm_g1_table`): signed digits halve the buckets and let c grow to 13;
phase 1 walks `serial` steps along each lane, each step ONE launch of
kernel C (sign select + unsafe mixed add + segment restart + collision
flag); the lane tails, the bucket correction and the bucket reduction use
complete adds with the select inside (kernel B) at 1/serial of the width;
each bucket's sum is gathered from its segment end, found with a
searchsorted on the sorted digits.  An unsafe add that met P == +-Q or an accumulator at infinity
raises `bad`, and the entry points then recompute through `msm_g1`.

The window sums come back to the host affine, and the Horner combine
Σ_w 2^(cw)·S_w runs on python ints.  An MSM result is one point whatever
the order of equal digits; the sorts are stable, as the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bn254, kernels
from .bn254 import PointJ, from_affine, point_add, to_affine

DEFAULT_C = 8  # window bits: 32 windows of 256 buckets over 254-bit scalars
DEFAULT_SERIAL = 32  # serial steps per lane of the blocked scans


def scalar_limbs(scalars, nbits: int = 254) -> np.ndarray:
    """Host ints -> (N, K) uint32 little-endian limbs, K = ceil(nbits/32)."""
    nlimbs = (nbits + 31) // 32
    buf = b"".join(int(s).to_bytes(nlimbs * 4, "little") for s in scalars)
    return np.frombuffer(buf, dtype=np.uint32).reshape(len(scalars), nlimbs).copy()


def scalar_digits(scalars, c: int = DEFAULT_C, nbits: int = 254) -> np.ndarray:
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


def digits_from_limbs(limbs: torch.Tensor, c: int = DEFAULT_C, nbits: int = 254) -> torch.Tensor:
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


def _check_top_window(c: int, nbits: int = 254) -> None:
    """Signed digits carry into the next window; the top one must have room."""
    if not (nbits % c < c - 1 or nbits % c == 0):
        raise ValueError(f"c = {c}: the top window of {nbits}-bit scalars could overflow")


def signed_digits_from_limbs(limbs: torch.Tensor, c: int = 13, nbits: int = 254):
    """Device: (N, K) int64 tensor of 32-bit limbs -> signed window digits
    (mag, sign): mag (W, N) int64 in [0, 2^(c-1)], sign (W, N) bool, True
    for negative digits and never where mag == 0.

    A digit above 2^(c-1) becomes its negative complement and carries one
    into the next window, so Σ_w (-1)^sign·mag·2^(cw) is the scalar.  Needs
    nbits mod c < c-1 (or 0) so the top window cannot overflow."""
    _check_top_window(c, nbits)
    du = digits_from_limbs(limbs, c, nbits)  # (W, N) in [0, 2^c)
    half, full = 1 << (c - 1), 1 << c
    carry = torch.zeros_like(du[0]) if du.shape[0] else None
    mags, signs = [], []
    for d in du:
        d2 = d + carry
        wrap = d2 > half
        mags.append(torch.where(wrap, full - d2, d2))
        signs.append(wrap)
        carry = wrap.to(du.dtype)
    mag, sign = torch.stack(mags, dim=0), torch.stack(signs, dim=0)
    return mag, sign & (mag != 0)


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
    """The EC group op as the MSM machinery sees it (elements: PointJ).

    Over the dispatching field ops every add is kernel B on CUDA tensors
    (`kernels.point_add` for G1, `kernels.point_add_g2` for G2) and its
    plain version on the CPU; over plain field ops it is the generic
    `bn254.point_add`."""

    def __init__(self, F):
        self.F = F
        self._is_g1 = isinstance(F, bn254.FqOps)

    def add(self, a: PointJ, b: PointJ) -> PointJ:
        return self._add(a, b, None, 0)

    def add_select(self, mask, a: PointJ, b: PointJ, keep: int) -> PointJ:
        """select(mask, kept, a + b) with kept = a (keep = 0) or b (keep = 1):
        where the mask is set the kept operand's limbs pass unchanged,
        whatever the add would give.  mask: bool, broadcastable to the batch
        shape of the points."""
        return self._add(a, b, mask, keep)

    def _add(self, a: PointJ, b: PointJ, mask, keep: int) -> PointJ:
        shape = _first_leaf(a).shape
        if _first_leaf(b).shape != shape:
            shape = torch.broadcast_shapes(shape, _first_leaf(b).shape)
            a, b = (_tmap(lambda t: t.expand(shape), x) for x in (a, b))
        if self.F.plain:
            out = point_add(self.F, a, b)
            return out if mask is None else self.select(mask, (a, b)[keep], out)
        flat = lambda t: t.reshape(16, -1).contiguous()  # noqa: E731
        if mask is not None:
            mask = mask.expand(shape[1:]).reshape(-1).to(torch.int32)
        ctx = self.F.ctx if self._is_g1 else self.F.fq.ctx
        add = kernels.point_add if self._is_g1 else kernels.point_add_g2
        out = add(ctx, _tmap(flat, tuple(a)), _tmap(flat, tuple(b)), mask, keep)
        return PointJ(*_tmap(lambda t: t.reshape(shape), out))

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
        # f carries a leading 1 for the limb axis; the mask has batch rank
        v = G.add_select(~(valid & ~f)[0], sh_v, v, keep=1)
        f = f | (valid & torch.roll(f, s, dims=-1))
    return v


def _blocked_seg_scan(G, pts, flags, serial: int = DEFAULT_SERIAL):
    """O(N) two-phase segmented inclusive scan along the last axis:
      phase 1  N viewed as (C lanes x S serial): lane-local segmented sums,
               one full-width group op per serial step
      phase 2  lane tails combine with a small segmented scan over C
      phase 3  one masked add folds each lane's inflow into its head run
    flags: one rank less than the leaves (broadcasts in selects)."""
    n = flags.shape[-1]
    S = serial
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
        acc = G.add_select(lane_start[..., i], acc, val, keep=1)
        outs.append(acc)
    scanned = _tmap(lambda *ls: torch.stack(ls, dim=-1), *outs)

    tails = _tmap(lambda l: l[..., -1], scanned)
    lane_scan = _hs_scan(G, tails, flags_r.any(dim=-1))
    shifted = _tmap(lambda l: torch.roll(l, 1, dims=-1), lane_scan)
    connected = (torch.arange(C, device=flags.device) > 0) & ~flags_r[..., 0]
    inflow = G.select(connected, shifted, _tmap(torch.zeros_like, shifted))

    head = torch.cumsum(flags_r.to(torch.int32), dim=-1) == 0
    inflow_b = _tmap(lambda l: l[..., None].expand(l.shape + (S,)), inflow)
    fixed = G.add_select(~head, scanned, inflow_b, keep=0)
    return _tmap(lambda l: l.reshape(l.shape[:-2] + (n,)), fixed)


def _blocked_scan(G, pts, reverse: bool = False, serial: int = DEFAULT_SERIAL):
    """O(N) plain inclusive scan along the last axis (one segment)."""
    if reverse:
        pts = _tmap(lambda l: torch.flip(l, dims=(-1,)), pts)
    leaf = _first_leaf(pts)
    flags = torch.zeros(leaf.shape[1:], dtype=torch.bool, device=leaf.device)
    out = _blocked_seg_scan(G, pts, flags, serial)
    if reverse:
        out = _tmap(lambda l: torch.flip(l, dims=(-1,)), out)
    return out


def msm_window_sums(G, points, digits: torch.Tensor, c: int = DEFAULT_C):
    """Per-window bucket-aggregated sums S_w = Σ_b b·B_b, all windows at
    once; points (16, N) leaves, digits (W, N) of c bits -> leaves (..., W)."""
    nbuckets = 1 << c
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


# ---------------------------------------------------------------------------
# fast G1 path: signed digits, unsafe mixed adds fused with the sign select
# and the segment restart in kernel C, and bucket sums gathered from their
# segment ends.  About a third of the field products per point of the
# complete-add schedule above, which stays as the collision fallback.


def _scan_step(F, acc: PointJ, qx, qy, sgn, flg):
    """One MSM phase-1 step: y' = -qy where sgn, unsafe mixed add of
    (qx, y') into acc, restart with (qx, y', one) where flg.  sgn, flg:
    bool or int32 masks of the batch shape.  Returns (PointJ, bad), bad a
    bool tensor already masked by ~flg.

    For FqOps this is `kernels.point_scan_step`: kernel C on CUDA tensors,
    its plain version on the CPU."""
    if not isinstance(F, bn254.FqOps) or F.plain:
        raise TypeError("the fused scan step exists for G1 over the dispatching FqOps only")
    shape = acc.x.shape
    flat = lambda t: t.reshape(16, -1).contiguous()  # noqa: E731
    mask = lambda t: t.to(torch.int32).reshape(-1).contiguous()  # noqa: E731
    x3, y3, z3, bad = kernels.point_scan_step(
        F.ctx, tuple(map(flat, acc)), (flat(qx), flat(qy)), mask(sgn), mask(flg)
    )
    out = PointJ(*(t.reshape(shape) for t in (x3, y3, z3)))
    return out, bad.reshape(shape[1:]) != 0


def g1_window_sums_fast(F, xs, ys, inf, mag, sign, c: int = 13,
                        serial: int = DEFAULT_SERIAL, window_group: int = 32):
    """Per-window sums S_w = Σ_b b·B_b from signed digits, fast schedule.

    xs, ys: (16, N) affine Montgomery coordinates; inf: (N,) bool;
    mag / sign: (W, N) signed digits.  Returns (PointJ with (16, W) leaves,
    bad: a 0-d bool tensor, True when an unsafe add hit P == +-Q or an
    accumulator at infinity, so the caller must recompute through the
    complete-add schedule).

    Per group of g windows:
      sort     stable sort by digit magnitude; the order carries the sign
      phase 1  N viewed as (C lanes x S serial steps); step i gathers its
               (16, g·C) points and makes ONE launch of kernel C
      phase 2  lane tails combine with complete adds at width C
      buckets  searchsorted on the sorted digits finds each bucket's
               segment end; one gather reads the B sums there, and a
               bucket that crosses its lane's start takes the lane's inflow
               by one complete add; absent buckets become infinities
      reduce   suffix scan + total scan over the B bucket sums

    The serial depth halves until it divides N (no padding: two infinities
    side by side in bucket 0 would raise `bad`)."""
    G = ECGroup(F)
    n_windows, n = mag.shape
    dev = xs.device
    B = 1 << (c - 1)
    mag = torch.where(inf[None, :], torch.zeros_like(mag), mag)
    S_ = serial
    while n % S_:
        S_ //= 2
    C = n // S_

    window_sums = []
    bad_any = torch.zeros((), dtype=torch.bool, device=dev)
    for w0 in range(0, n_windows, window_group):
        mg = mag[w0 : w0 + window_group]
        g = mg.shape[0]
        mag_s, order = torch.sort(mg, dim=-1, stable=True)
        sign_s = torch.gather(sign[w0 : w0 + window_group], 1, order)
        first = torch.ones((g, 1), dtype=torch.bool, device=dev)
        flags = torch.cat([first, mag_s[:, 1:] != mag_s[:, :-1]], dim=-1)

        # --- phase 1: one kernel C launch per serial step -------------------
        # step-major (S, g·C) index and mask stacks, so each step's slice is
        # contiguous and its gather lands as kernel C's (16, g·C) operand
        fr = flags.reshape(g, C, S_)
        lane_start = fr.clone()
        lane_start[..., 0] = True
        step_major = lambda t: t.permute(2, 0, 1).reshape(S_, g * C).contiguous()  # noqa: E731
        order_t = step_major(order.reshape(g, C, S_))
        f_t = step_major(lane_start.to(torch.int32))
        s_t = step_major(sign_s.reshape(g, C, S_).to(torch.int32))

        zeros = torch.zeros((16, g, C), dtype=xs.dtype, device=dev)
        acc = PointJ(zeros, zeros, zeros)
        badp = torch.zeros((g, C), dtype=torch.bool, device=dev)
        # every step's running sums, kept for the bucket gather below
        scanned = PointJ(*(torch.empty((S_, 16, g, C), dtype=xs.dtype, device=dev)
                           for _ in range(3)))
        for i in range(S_):
            xv = xs.index_select(1, order_t[i]).reshape(16, g, C)
            yv = ys.index_select(1, order_t[i]).reshape(16, g, C)
            acc, b = _scan_step(F, acc, xv, yv, s_t[i].reshape(g, C), f_t[i].reshape(g, C))
            badp |= b
            for kept, leaf in zip(scanned, acc):
                kept[i] = leaf
        tails = acc
        bad_any = bad_any | badp.any()

        # --- phase 2: combine lane tails (complete adds, width C) -----------
        has_flag = fr.any(dim=-1)
        if C > 64:
            lane_scan = _blocked_seg_scan(G, tails, has_flag, serial)
        else:
            lane_scan = _hs_scan(G, tails, has_flag)
        shifted = _tmap(lambda l: torch.roll(l, 1, dims=-1), lane_scan)
        connected = (torch.arange(C, device=dev) > 0) & ~fr[..., 0]
        inflow = G.select(connected, shifted, _tmap(torch.zeros_like, shifted))

        # --- buckets: gather each bucket's segment-end sum ------------------
        ids = torch.arange(B + 1, dtype=mag_s.dtype, device=dev).expand(g, B + 1).contiguous()
        right = torch.searchsorted(mag_s, ids, right=True)  # #elements <= id
        left = torch.searchsorted(mag_s, ids, right=False)  # #elements < id
        hist = right - left
        present = hist > 0
        pos_c = torch.clamp(right - 1, min=0)  # inclusive end of bucket b
        end_lane = pos_c // S_
        end_step = pos_c % S_
        seg_start = pos_c - hist + 1  # first sorted index of bucket b
        g_idx = torch.arange(g, device=dev)[:, None]
        # scanned leaves are (S, 16, g, C): [end_step, :, g, end_lane] gives
        # (g, B+1, 16) -> (16, g, B+1)
        val = _tmap(lambda l: l[end_step, :, g_idx, end_lane].movedim(-1, 0), scanned)
        inflow_b = _tmap(lambda l: l[:, g_idx, end_lane], inflow)
        needs = present & (seg_start < end_lane * S_)
        # val + (needs ? inflow : infinity): a complete add with infinity passes
        # val's limbs through, which is what the mask does inside the kernel.
        # One difference from the JAX package (eigen_zeth_tpu/ops/msm.py, the
        # same correction): where val itself is at infinity its x and y limbs
        # pass through here, and come out all zero there (inf + inf selects the
        # second operand).  The point is the same infinity, and z = 0 in a
        # phase-1 accumulator has already raised `bad`.
        corrected = G.add_select(~needs, val, inflow_b, keep=0)
        ez = torch.where(present, corrected.z, torch.zeros_like(corrected.z))
        E = PointJ(corrected.x[..., 1:], corrected.y[..., 1:], ez[..., 1:])

        # --- reduce: S_w = Σ_b b·B_b by suffix + total scans ----------------
        suffix = _blocked_scan(G, E, reverse=True, serial=serial)
        total = _blocked_scan(G, suffix, serial=serial)
        window_sums.append(_tmap(lambda l: l[..., -1], total))

    S = _tmap(lambda *ls: torch.cat(ls, dim=-1), *window_sums)
    return S, bad_any


def _host_horner(windows, c: int, fq2: bool = False):
    """Host combine Σ_w 2^(cw)·S_w (python ints)."""
    Fh = bn254.HOST_FQ2 if fq2 else bn254.HOST_FQ
    acc = None
    for S_w in reversed(windows):
        for _ in range(c):
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
    """Pad to a multiple of DEFAULT_SERIAL with infinities (digit 0, bucket
    0), so the blocked scans run full serial lanes.  Only the complete-add
    schedule may do this: on the fast path two neighbouring infinities
    raise `bad`."""
    pad = (-len(points_int)) % DEFAULT_SERIAL
    return list(points_int) + [None] * pad, list(scalars) + [0] * pad


def _limbs_tensor(scalars, device) -> torch.Tensor:
    """(N, 8) int64 tensor of the scalars' 32-bit limbs; scalars already in
    that form (a tensor) pass through."""
    if isinstance(scalars, torch.Tensor):
        return scalars.to(device)
    return torch.from_numpy(scalar_limbs(scalars).astype(np.int64)).to(device)


# (window, point) pairs a pass of the complete-add schedule: the gathered
# (16, W, N) planes of an MSM over millions of points (the STARK wrap's
# Groth16) would not fit the card's memory all at once, so such an MSM runs
# its windows a few at a time; below 2^19 points all 32 run in one pass
WINDOW_PAIRS = 1 << 24


def _window_sums(F, pts, scalars, c, device):
    """Affine window sums on the host; pts come padded like scalars."""
    digits = digits_from_limbs(_limbs_tensor(scalars, device), c)
    G = ECGroup(F)
    group = max(1, WINDOW_PAIRS // max(1, len(scalars)))
    parts = [msm_window_sums(G, pts, digits[g : g + group], c)
             for g in range(0, digits.shape[0], group)]
    S = _tmap(lambda *ls: torch.cat(ls, dim=-1), *parts)
    ax, ay = to_affine(F, S)
    return F.to_int(ax), F.to_int(ay), F.is_zero(S.z).cpu().numpy()


def _affine_windows(xs, ys, inf):
    return [None if inf[w] else (int(xs[w]), int(ys[w])) for w in range(len(inf))]


def msm_g1(points_int, scalars, c: int = DEFAULT_C, *, device):
    """Σ s_i·P_i on G1 on `device` by the complete-add schedule; host ints
    in, affine host ints out (None = infinity)."""
    F = bn254.FqOps()
    points_int, scalars = _pad(points_int, scalars)
    xs, ys, inf = _window_sums(F, _g1_device_points(points_int, device), scalars, c, device)
    return _host_horner(_affine_windows(xs, ys, inf), c)


def msm_g2(points_int, scalars, c: int = DEFAULT_C, *, device):
    """Σ s_i·P_i on G2 on `device`; affine ((x0, x1), (y0, y1)) out."""
    F = bn254.Fq2Ops()
    points_int, scalars = _pad(points_int, scalars)
    (x0, x1), (y0, y1), inf = _window_sums(F, _g2_device_points(points_int, device), scalars,
                                           c, device)
    windows = [
        None if inf[w] else ((int(x0[w]), int(x1[w])), (int(y0[w]), int(y1[w])))
        for w in range(len(inf))
    ]
    return _host_horner(windows, c, fq2=True)


def msm_affine(x, y, inf: torch.Tensor, scalars, g2: bool = False, c: int = DEFAULT_C):
    """Σ s_i·P_i by the complete-add schedule over affine points already on
    the device (Montgomery limbs: (16, N) for G1, (c0, c1) pairs for G2;
    inf an (N,) bool mask); affine host ints out (None = infinity).
    scalars: host ints, or an (N, 8) int64 tensor of canonical scalars'
    32-bit limbs on the device."""
    F = bn254.Fq2Ops() if g2 else bn254.FqOps()
    pad = (-inf.shape[0]) % DEFAULT_SERIAL
    if pad:
        x, y = (_tmap(lambda l: torch.cat([l, l.new_zeros((16, pad))], dim=1), t) for t in (x, y))
        inf = torch.cat([inf, inf.new_ones(pad)])
    if isinstance(scalars, torch.Tensor):
        scalars = torch.cat([scalars, scalars.new_zeros((pad, scalars.shape[1]))])
    else:
        scalars = [int(s) % bn254.R for s in scalars] + [0] * pad
    xs, ys, winf = _window_sums(F, from_affine(F, x, y, is_inf=inf), scalars, c, inf.device)
    if g2:
        (x0, x1), (y0, y1) = xs, ys
        windows = [None if winf[w] else ((int(x0[w]), int(x1[w])), (int(y0[w]), int(y1[w])))
                   for w in range(len(winf))]
        return _host_horner(windows, c, fq2=True)
    return _host_horner(_affine_windows(xs, ys, winf), c)


# ---------------------------------------------------------------------------
# fast G1 entry points (host ints out)


def gen_test_points(n_log2: int, seed: int = 5, *, device):
    """2^n distinct G1 points on `device` with known discrete logs.

    P_{a,b} = B_a + C_b from two sqrt-size host sets, so the correctness
    gate of a large MSM is ONE host scalar multiplication of G by Σ s_i·k_i.
    Returns (xs, ys, dlogs): affine Montgomery limbs (16, 2^n) and the host
    dlog list."""
    if n_log2 < 2:
        raise ValueError("gen_test_points needs n_log2 >= 2")
    h = n_log2 // 2
    na, nb = 1 << (n_log2 - h), 1 << h
    rng = np.random.default_rng(seed)
    ka = [int(x) for x in rng.integers(1, 1 << 60, size=na, dtype=np.int64)]
    kb = [int(x) << 61 for x in rng.integers(1, 1 << 60, size=nb, dtype=np.int64)]
    A = [bn254.h_ec_mul_jac_f(k, bn254.G1_GEN) for k in ka]
    B = [bn254.h_ec_mul_jac_f(k, bn254.G1_GEN) for k in kb]
    F = bn254.FqOps()
    G = ECGroup(F)

    def axis(points, coord, shape):
        return F.ctx.from_int([p[coord] for p in points], device).reshape(shape)

    ax, ay = (axis(A, k, (16, na, 1)) for k in (0, 1))
    bx, by = (axis(B, k, (16, 1, nb)) for k in (0, 1))
    one = F.ctx.one_mont((1, 1), device)
    full = (16, na, nb)
    pa = PointJ(*(t.expand(full) for t in (ax, ay, one)))
    pb = PointJ(*(t.expand(full) for t in (bx, by, one)))
    xs, ys = to_affine(F, G.add(pa, pb))
    dlogs = [ka[i] + kb[j] for i in range(na) for j in range(nb)]
    return xs.reshape(16, -1), ys.reshape(16, -1), dlogs


def _msm_g1_fast_windows(xs, ys, inf, limbs, c, serial, window_group):
    """The fast schedule end to end on the device: limb scalars -> signed
    digits -> window sums -> affine.  Returns (ax, ay, inf_w, bad), bad a
    0-d bool tensor: True means the caller must recompute through the
    complete-add schedule."""
    F = bn254.FqOps()
    mag, sign = signed_digits_from_limbs(limbs, c=c)
    S, bad = g1_window_sums_fast(F, xs, ys, inf, mag, sign, c=c, serial=serial,
                                 window_group=window_group)
    ax, ay = to_affine(F, S)
    return ax, ay, F.is_zero(S.z), bad


def host_points(F, xs, ys, inf):
    xs_i, ys_i, inf_h = F.to_int(xs), F.to_int(ys), inf.cpu().numpy()
    return [None if inf_h[i] else (int(xs_i[i]), int(ys_i[i])) for i in range(len(inf_h))]


def msm_g1_device(xs, ys, inf, scalars, c: int | None = None,
                  serial: int = DEFAULT_SERIAL, window_group: int = 32):
    """Fast G1 MSM over points already on the device as Montgomery limbs
    (a KZG SRS): xs, ys (16, N), inf (N,) bool; host scalars in, host
    affine ints out.  It runs where the points lie.

    c=None picks the window width from N (the bucket reduction, W·2^(c-1)
    adds, must not swamp the N·W scan).  Sound for arbitrary inputs: when
    an unsafe add raises `bad`, the complete-add schedule recomputes."""
    F = bn254.FqOps()
    if c is None:
        n = xs.shape[1]
        c = 13 if n >= 4096 else (8 if n >= 256 else 4)
    limbs = _limbs_tensor(scalars, xs.device)
    ax, ay, inf_w, bad = _msm_g1_fast_windows(xs, ys, inf, limbs, c, serial, window_group)
    if bool(bad):
        return msm_g1(host_points(F, xs, ys, inf), scalars, device=xs.device)
    return _host_horner(_affine_windows(F.to_int(ax), F.to_int(ay), inf_w.cpu().numpy()), c)


def msm_g1_fast(points_int, scalars, c: int = 13, serial: int = DEFAULT_SERIAL,
                window_group: int = 32, *, device):
    """Σ s_i·P_i on G1 on `device` by the fast schedule; host ints in,
    affine host ints out (None = infinity).  Uploads the points, then
    `msm_g1_device`."""
    F = bn254.FqOps()
    p = _g1_device_points(points_int, device)
    return msm_g1_device(p.x, p.y, F.is_zero(p.z), scalars, c, serial, window_group)


# ---------------------------------------------------------------------------
# fixed-base MSM: with T[w·N+i] = 2^(cw)·P_i precomputed, the W windows
# merge into ONE window over W·N digit/point pairs: one bucket reduction of
# 2^(c-1) sums, no Horner combine.


class G1Table:
    """Precomputed fixed-base table for msm_g1_table (on the device)."""

    def __init__(self, txs, tys, tinf, c: int, n: int):
        self.txs, self.tys, self.tinf = txs, tys, tinf
        self.c = c
        self.n = n
        self.n_windows = (254 + c - 1) // c


def g1_build_table(points_int, c: int = 16, *, device) -> G1Table:
    """Precompute the fixed-base window table on `device` (once per SRS):
    slab w holds 2^(cw)·P_i, by c Jacobian doublings per window and one
    Jacobian -> affine conversion of the whole table."""
    _check_top_window(c)
    F = bn254.FqOps()
    W = (254 + c - 1) // c
    p = _g1_device_points(points_int, device)
    inf = F.is_zero(p.z)
    slabs = []
    for _ in range(W):
        slabs.append(p)
        for _ in range(c):
            p = bn254.point_double(F, p)
    tj = _tmap(lambda *ls: torch.cat(ls, dim=1), *slabs)  # (16, W·N), w-major
    txs, tys = to_affine(F, tj)
    return G1Table(txs, tys, inf.repeat(W), c, len(points_int))


def msm_g1_table(table: G1Table, scalars, serial: int = DEFAULT_SERIAL):
    """Σ s_i·P_i against a precomputed G1Table; host affine ints out.  On a
    collision the complete-add schedule recomputes on the base points."""
    F = bn254.FqOps()
    device = table.txs.device
    mag, sign = signed_digits_from_limbs(_limbs_tensor(scalars, device), c=table.c)
    S, bad = g1_window_sums_fast(
        F, table.txs, table.tys, table.tinf, mag.reshape(1, -1), sign.reshape(1, -1),
        c=table.c, serial=serial, window_group=1,
    )
    if bool(bad):
        n = table.n
        pts = host_points(F, table.txs[:, :n], table.tys[:, :n], table.tinf[:n])
        return msm_g1(pts, scalars, device=device)
    ax, ay = to_affine(F, S)
    if bool(F.is_zero(S.z)[0]):
        return None
    return int(F.to_int(ax)[0]), int(F.to_int(ay)[0])
