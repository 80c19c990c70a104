"""KZG polynomial commitments over BN254 — port of eigen_zeth_tpu/models/kzg.py.

  * commit  = one fast G1 MSM of the coefficient vector against the G1 SRS
              (ops/msm.py:msm_g1_device: signed digits, kernel C per serial
              step)
  * open    = quotient q(x) = (p(x) - p(z)) / (x - z) without the sequential
              synthetic-division recurrence: with S_i = Σ_{j>=i} c_j z^j (a
              log-depth suffix scan on the device), q_i = S_{i+1}·z^{-(i+1)},
              all wide Fr ops whose products are kernel A, then an MSM of q
              against the SRS.  p(z) = S_0 falls out for free
  * verify  = host pairing check e(C - [y]G1, [1]G2) == e(π, [τ-z]G2)
              (ops/pairing.py; verification is host-side throughout)

SRS: `setup_insecure` derives [τ^i]G1 from a known τ for tests and smoke
runs, on the device by a 254-step double-and-add over the whole power
vector (complete adds, kernel B).  A deployment loads a ceremony SRS into
`Srs` directly.  Every entry point takes the device it runs on, or runs
where the SRS lies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..ops import bn254, msm
from ..ops import pairing as pr
from ..ops.bigint import MontCtx
from ..ops.bn254 import G1_GEN, G2_GEN_X, G2_GEN_Y, PointJ, h_ec_add, h_ec_mul


@dataclass
class Srs:
    """[1, τ, τ², …]·G1 (limb tensors on one device) + [τ]·G2 (host affine)."""

    g1_x: torch.Tensor  # (16, n) Montgomery x-coordinates
    g1_y: torch.Tensor  # (16, n)
    g1_inf: torch.Tensor  # (n,) bool
    g2_tau: tuple  # ((x0, x1), (y0, y1)) host ints

    @property
    def n(self) -> int:
        return self.g1_x.shape[1]

    @property
    def device(self) -> torch.device:
        return self.g1_x.device

    def g1_points_host(self):
        """Affine host-int points (None = infinity)."""
        return msm.host_points(bn254.FqOps(), self.g1_x, self.g1_y, self.g1_inf)


def _fr() -> MontCtx:
    return bn254.fr()


def _fr_powers(ctx: MontCtx, base: int, n: int, device) -> torch.Tensor:
    """[1, b, …, b^{n-1}] in Montgomery form, built on the device by block
    doubling: block [t, 2t) = block [0, t)·b^t, so log2(n) wide products."""
    out = ctx.one_mont((1,), device)
    total = 1
    while total < n:
        step = min(total, n - total)
        factor = ctx.const_mont(pow(base, total, ctx.q), (step,), device)
        out = torch.cat([out, ctx.mont_mul(out[:, :step], factor)], dim=-1)
        total += step
    return out


def setup_insecure(n: int, tau: int, device, on_device: bool = True) -> Srs:
    """Derive an SRS on `device` from a KNOWN τ: tests and smoke runs only
    (a deployment loads a ceremony SRS whose τ was destroyed).

    on_device (and n > 64): τ powers by the Fr ladder, then one 254-step
    double-and-add sweep that adds 2^j·G into every lane whose scalar has
    bit j, complete adds at full width.  Otherwise host scalar
    multiplications, uploaded."""
    g2_tau = h_ec_mul(tau, (G2_GEN_X, G2_GEN_Y), bn254.HOST_FQ2)
    F = bn254.FqOps()
    if not on_device or n <= 64:
        pts = [h_ec_mul(pow(tau, i, bn254.R), G1_GEN) for i in range(n)]
        xs = F.ctx.from_int([p[0] if p else 0 for p in pts], device)
        ys = F.ctx.from_int([p[1] if p else 0 for p in pts], device)
        inf = torch.tensor([p is None for p in pts], device=device)
        return Srs(xs, ys, inf, g2_tau)

    frc = _fr()
    G = msm.ECGroup(F)
    # canonical limbs of τ^i: a Montgomery product with 1 strips the R factor
    taus = frc.mont_mul(_fr_powers(frc, tau, n, device),
                        frc.from_int([1], device, mont=False))

    dbl = [G1_GEN]
    for _ in range(253):
        dbl.append(h_ec_add(dbl[-1], dbl[-1]))
    tx = F.ctx.from_int([p[0] for p in dbl], device)  # (16, 254)
    ty = F.ctx.from_int([p[1] for p in dbl], device)

    zeros = torch.zeros((16, n), dtype=torch.int32, device=device)
    one = F.one_like(zeros)
    acc = PointJ(zeros, zeros, zeros)
    for j in range(254):
        bit = ((taus[j // 16] >> (j % 16)) & 1).bool()
        px = tx[:, j : j + 1].expand(16, n)
        py = ty[:, j : j + 1].expand(16, n)
        acc = G.add_select(~bit, acc, PointJ(px, py, one), keep=0)
    ax, ay = bn254.to_affine(F, acc)
    return Srs(ax, ay, F.is_zero(acc.z), g2_tau)


def commit(srs: Srs, coeffs: Sequence[int]):
    """C = Σ c_i·[τ^i]G1: one fast MSM on the SRS's device.  Returns affine
    host ints."""
    n = len(coeffs)
    if n > srs.n:
        raise ValueError(f"{n} coefficients exceed the SRS size {srs.n}")
    return msm.msm_g1_device(srs.g1_x[:, :n].contiguous(), srs.g1_y[:, :n].contiguous(),
                             srs.g1_inf[:n], list(coeffs))


def _suffix_sums(ctx: MontCtx, t: torch.Tensor) -> torch.Tensor:
    """S_i = Σ_{j>=i} t_j along the last axis: a log-depth (Hillis-Steele)
    scan over ctx.add.  Field addition is exact, so the order of the adds
    does not change a value."""
    n = t.shape[-1]
    shift = 1
    while shift < n:
        pad = torch.zeros_like(t[:, :shift])
        t = ctx.add(t, torch.cat([t[:, shift:], pad], dim=-1))
        shift *= 2
    return t


def _quotient(c_mont, zpow, zinv_pow):
    """q_i = (Σ_{j>=i+1} c_j z^j)·z^{-(i+1)}; also returns p(z)."""
    frc = _fr()
    suffix = _suffix_sums(frc, frc.mont_mul(c_mont, zpow))  # S_i
    p_z = suffix[:, 0]
    s_next = torch.cat([suffix[:, 1:], torch.zeros_like(suffix[:, :1])], dim=1)  # S_{i+1}
    return frc.mont_mul(s_next, zinv_pow), p_z


def open_at(srs: Srs, coeffs: Sequence[int], z: int):
    """KZG opening of p at z on the SRS's device: (proof_point, y = p(z))."""
    frc = _fr()
    device = srs.device
    n = len(coeffs)
    z = z % bn254.R
    if z == 0:
        y = coeffs[0] % bn254.R
        q = [int(c) % bn254.R for c in coeffs[1:]]
    else:
        c_mont = frc.from_int(list(coeffs), device)
        zpow = _fr_powers(frc, z, n, device)
        zinv = pow(z, bn254.R - 2, bn254.R)
        # z^{-(i+1)} = z^{-1}·(z^{-1})^i
        zinv_pow = frc.mont_mul(_fr_powers(frc, zinv, n, device),
                                frc.const_mont(zinv, (n,), device))
        q_m, y_m = _quotient(c_mont, zpow, zinv_pow)
        y = int(frc.to_int(y_m))
        q = [int(v) for v in frc.to_int(q_m[:, : n - 1])]
    m = max(len(q), 1)
    proof = msm.msm_g1_device(srs.g1_x[:, :m].contiguous(), srs.g1_y[:, :m].contiguous(),
                              srs.g1_inf[:m], q if q else [0])
    return proof, y


def verify(srs: Srs, commitment, z: int, y: int, proof) -> bool:
    """Host pairing check: e(C - [y]G1, [1]G2) == e(π, [τ-z]G2)."""
    z, y = z % bn254.R, y % bn254.R
    g2_gen = (G2_GEN_X, G2_GEN_Y)
    c_minus_y = h_ec_add(commitment, h_ec_mul((bn254.R - y) % bn254.R, G1_GEN))
    tau_minus_z = h_ec_add(
        srs.g2_tau,
        h_ec_mul((bn254.R - z) % bn254.R, g2_gen, bn254.HOST_FQ2),
        bn254.HOST_FQ2,
    )
    if proof is None:
        # zero quotient: valid iff C == [y]G1
        return c_minus_y is None
    return _pairing_or_one(c_minus_y, g2_gen) == _pairing_or_one(proof, tau_minus_z)


def _pairing_or_one(p, q2):
    if p is None or q2 is None:
        return pr.F12_ONE
    return pr.pairing(p, q2)
