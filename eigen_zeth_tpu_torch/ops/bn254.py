"""BN254 (alt_bn128) curve arithmetic — port of eigen_zeth_tpu/ops/bn254.py.

  * Fq / Fr through the Montgomery engine in ops/bigint.py; every Fq
    multiply is kernel A on a CUDA tensor
  * Fq2 = Fq[u]/(u^2+1) built on top
  * Jacobian point add/double written once against a small field-ops
    interface, so G1 (Fq) and G2 (Fq2) share the formulas — branch-free
    (infinity / P == Q / P == -Q resolved by selects).  The adds of the
    MSMs go to kernel B instead, G1 and G2 alike (ops/msm.py:ECGroup),
    and the unsafe mixed add on G1 to kernel D
  * the host reference (python ints, affine) used by tests, setup and the
    Groth16 verifier

Point representation: PointJ(x, y, z), each coordinate a (16, ...) int32
limb tensor (Fq) or a pair of them (Fq2); infinity is z == 0.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .bigint import MontCtx, mont_ctx

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

G1_GEN = (1, 2)

G2_GEN_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

B_G1 = 3
# b2 = 3 / (9 + u) in Fq2; (9 + u)^-1 = (9 - u) / 82
_NINE_U_INV = pow(9 * 9 + 1, Q - 2, Q)
B_G2 = ((3 * 9 * _NINE_U_INV) % Q, (-3 * _NINE_U_INV) % Q)


def fq() -> MontCtx:
    return mont_ctx(Q)


def fr() -> MontCtx:
    return mont_ctx(R)


# ---------------------------------------------------------------------------
# field-ops adapters: one interface over Fq and Fq2 elements


class FqOps:
    """Fq elements: (16, ...) int32 limbs in Montgomery form.

    plain=True multiplies with the plain version of kernel A on any device
    (the reference that kernel B is held against)."""

    def __init__(self, ctx: MontCtx | None = None, plain: bool = False):
        self.ctx = ctx or fq()
        self.plain = plain

    def add(self, a, b):
        return self.ctx.add(a, b)

    def sub(self, a, b):
        return self.ctx.sub(a, b)

    def neg(self, a):
        return self.ctx.neg(a)

    def mul(self, a, b):
        if self.plain:
            return self.ctx.mont_mul_plain(a, b)
        return self.ctx.mont_mul(a, b)

    def sq(self, a):
        return self.mul(a, a)

    def muls(self, xs, ys):
        """Several same-shape products in one multiply call (one launch)."""
        prod = self.mul(torch.stack(xs, dim=1), torch.stack(ys, dim=1))
        return prod.unbind(1)

    def is_zero(self, a):
        return self.ctx.is_zero(a)

    def select(self, pred, a, b):
        return torch.where(pred, a, b)

    def zero_like(self, a):
        return torch.zeros_like(a)

    def one_like(self, a):
        return self.ctx.one_mont(a.shape[1:], a.device)

    def inv(self, a):
        return self.ctx.inv(a)

    def double(self, a):
        return self.ctx.add(a, a)

    def to_int(self, a):
        return self.ctx.to_int(a)


class Fq2Ops:
    """Fq2 = Fq[u]/(u^2 + 1); elements are (c0, c1) pairs of Fq limbs.

    Both coordinates, and all Fq products of several Fq2 products, go
    through one stacked Fq call each, so an Fq2 op costs the dispatches of
    one Fq op.  plain=True multiplies with the plain version of kernel A on
    any device (the reference that the G2 point-add kernel is held
    against)."""

    def __init__(self, ctx: MontCtx | None = None, plain: bool = False):
        self.fq = FqOps(ctx, plain=plain)
        self.plain = plain

    def _pairwise(self, op, a, b):
        out = op(torch.stack(a, dim=1), torch.stack(b, dim=1))
        return (out[:, 0], out[:, 1])

    def add(self, a, b):
        return self._pairwise(self.fq.add, a, b)

    def sub(self, a, b):
        return self._pairwise(self.fq.sub, a, b)

    def neg(self, a):
        out = self.fq.neg(torch.stack(a, dim=1))
        return (out[:, 0], out[:, 1])

    def muls(self, xs, ys):
        """Several Fq2 products; Karatsuba:
        (a0+a1 u)(b0+b1 u) = (a0b0 - a1b1) + ((a0+a1)(b0+b1) - a0b0 - a1b1) u"""
        k = len(xs)
        a = torch.stack([torch.stack(x, dim=1) for x in xs], dim=1)  # (16, k, 2, ...)
        b = torch.stack([torch.stack(y, dim=1) for y in ys], dim=1)
        a0, a1, b0, b1 = a[:, :, 0], a[:, :, 1], b[:, :, 0], b[:, :, 1]
        t = self.fq.mul(
            torch.cat([a0, a1, self.fq.add(a0, a1)], dim=1),
            torch.cat([b0, b1, self.fq.add(b0, b1)], dim=1),
        )  # (16, 3k, ...): a0b0 | a1b1 | (a0+a1)(b0+b1)
        t0, t1, t2 = t[:, :k], t[:, k : 2 * k], t[:, 2 * k :]
        c0 = self.fq.sub(t0, t1)
        c1 = self.fq.sub(t2, self.fq.add(t0, t1))
        return [(c0[:, i], c1[:, i]) for i in range(k)]

    def mul(self, a, b):
        return self.muls([a], [b])[0]

    def sq(self, a):
        # (a0+a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
        t0, t1 = self.fq.muls((self.fq.add(a[0], a[1]), a[0]), (self.fq.sub(a[0], a[1]), a[1]))
        return (t0, self.fq.add(t1, t1))

    def is_zero(self, a):
        return self.fq.is_zero(a[0]) & self.fq.is_zero(a[1])

    def select(self, pred, a, b):
        return (self.fq.select(pred, a[0], b[0]), self.fq.select(pred, a[1], b[1]))

    def zero_like(self, a):
        return (self.fq.zero_like(a[0]), self.fq.zero_like(a[1]))

    def one_like(self, a):
        return (self.fq.one_like(a[0]), self.fq.zero_like(a[1]))

    def inv(self, a):
        # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
        norm = self.fq.add(self.fq.sq(a[0]), self.fq.sq(a[1]))
        ninv = self.fq.inv(norm)
        return (self.fq.mul(a[0], ninv), self.fq.neg(self.fq.mul(a[1], ninv)))

    def double(self, a):
        return self.add(a, a)

    def to_int(self, a):
        return (self.fq.to_int(a[0]), self.fq.to_int(a[1]))


# ---------------------------------------------------------------------------
# Jacobian point ops, generic over the field


class PointJ(NamedTuple):
    x: Any
    y: Any
    z: Any


def point_double(F, p: PointJ) -> PointJ:
    """dbl-2009-l for a = 0 curves."""
    A = F.sq(p.x)
    B = F.sq(p.y)
    C = F.sq(B)
    t = F.sq(F.add(p.x, B))
    D = F.double(F.sub(F.sub(t, A), C))
    E = F.add(F.add(A, A), A)
    FF = F.sq(E)
    X3 = F.sub(FF, F.double(D))
    C8 = F.double(F.double(F.double(C)))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
    Z3 = F.double(F.mul(p.y, p.z))
    return PointJ(X3, Y3, Z3)


def point_add(F, p: PointJ, q: PointJ) -> PointJ:
    """Complete Jacobian add (branch-free): handles inf, P==Q, P==-Q.

    The generic add (add-2007-bl) and the doubling (dbl-2009-l) of p are
    both computed, and selects pick the result.  The 23 products run in
    five dependency levels, each level one `F.muls` call."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    z1z1, z2z2, y1z2, y2z1, A, B, y1z1, zz = F.muls(
        [Z1, Z2, Y1, Y2, X1, Y1, Y1, F.add(Z1, Z2)],
        [Z1, Z2, Z2, Z1, X1, Y1, Z1, F.add(Z1, Z2)],
    )
    xb = F.add(X1, B)
    E = F.add(F.add(A, A), A)
    u1, u2, s1, s2, C, t, FF = F.muls([X1, X2, y1z2, y2z1, B, xb, E], [z2z2, z1z1, z2z2, z1z1, B, xb, E])
    h = F.sub(u2, u1)
    rr = F.sub(s2, s1)
    h2 = F.double(h)
    r2 = F.double(rr)
    D = F.double(F.sub(F.sub(t, A), C))
    xd = F.sub(FF, F.double(D))
    i, r2sq, zh, ed = F.muls(
        [h2, r2, F.sub(F.sub(zz, z1z1), z2z2), E], [h2, r2, h, F.sub(D, xd)]
    )
    j, v = F.muls([h, u1], [i, i])
    x3 = F.sub(F.sub(r2sq, j), F.double(v))
    ry, s1j = F.muls([r2, s1], [F.sub(v, x3), j])
    y3 = F.sub(ry, F.double(s1j))
    yd = F.sub(ed, F.double(F.double(F.double(C))))
    zd = F.double(y1z1)

    h_zero = F.is_zero(h)
    r_zero = F.is_zero(rr)
    p_inf = F.is_zero(Z1)
    q_inf = F.is_zero(Z2)
    use_dbl = h_zero & r_zero & ~p_inf & ~q_inf
    make_inf = h_zero & ~r_zero & ~p_inf & ~q_inf
    q_only = q_inf & ~p_inf

    x = F.select(use_dbl, xd, x3)
    y = F.select(use_dbl, yd, y3)
    z = F.select(use_dbl, zd, zh)
    z = F.select(make_inf, F.zero_like(z), z)
    x = F.select(p_inf, X2, F.select(q_only, X1, x))
    y = F.select(p_inf, Y2, F.select(q_only, Y1, y))
    z = F.select(p_inf, Z2, F.select(q_only, Z1, z))
    return PointJ(x, y, z)


def point_madd_unsafe(F, p: PointJ, qx, qy):
    """UNSAFE mixed add p + (qx, qy, 1): madd-2007-bl, 7M + 4S.

    No doubling or infinity branches: the point returned means nothing
    where `bad` is set, which is where H == 0 (P == +-Q) or p is at
    infinity.  Returns (PointJ, bad).  On G1 with CUDA tensors this is
    kernel D; over Fq2, with plain field ops and on the CPU it is the
    formula below."""
    if isinstance(F, FqOps) and not F.plain and p.x.device.type != "cpu":
        from . import kernels

        shape = p.x.shape
        flat = lambda t: t.expand(shape).reshape(16, -1).contiguous()  # noqa: E731
        x3, y3, z3, bad = kernels.point_madd(
            F.ctx, tuple(map(flat, p)), (flat(qx), flat(qy))
        )
        out = PointJ(*(t.reshape(shape) for t in (x3, y3, z3)))
        return out, bad.reshape(shape[1:]) != 0
    # the 11 products in five dependency levels, one `F.muls` call each
    z1z1 = F.sq(p.z)
    u2, z1c = F.muls([qx, p.z], [z1z1, z1z1])
    h = F.sub(u2, p.x)
    s2, hh = F.muls([qy, h], [z1c, h])
    i_ = F.double(F.double(hh))
    r = F.double(F.sub(s2, p.y))
    zh = F.add(p.z, h)
    j_, v, rr, zhzh = F.muls([h, p.x, r, zh], [i_, i_, r, zh])
    x3 = F.sub(F.sub(rr, j_), F.double(v))
    ry, yj = F.muls([r, p.y], [F.sub(v, x3), j_])
    y3 = F.sub(ry, F.double(yj))
    z3 = F.sub(F.sub(zhzh, z1z1), hh)
    bad = F.is_zero(h) | F.is_zero(p.z)
    return PointJ(x3, y3, z3), bad


def point_neg(F, p: PointJ) -> PointJ:
    return PointJ(p.x, F.neg(p.y), p.z)


def to_affine(F, p: PointJ):
    """Jacobian -> affine (x/z^2, y/z^3); infinity -> (0, 0)."""
    zinv = F.inv(p.z)
    zinv2 = F.sq(zinv)
    zinv3 = F.mul(zinv2, zinv)
    ax = F.mul(p.x, zinv2)
    ay = F.mul(p.y, zinv3)
    inf = F.is_zero(p.z)
    return F.select(inf, F.zero_like(ax), ax), F.select(inf, F.zero_like(ay), ay)


def from_affine(F, x, y, is_inf=None) -> PointJ:
    one = F.one_like(x)
    z = one
    if is_inf is not None:
        z = F.select(is_inf, F.zero_like(one), one)
    return PointJ(x, y, z)


# ---------------------------------------------------------------------------
# host reference: affine python-int arithmetic (tests, setup, verifier)


def h_fq2_mul(a, b):
    return (
        (a[0] * b[0] - a[1] * b[1]) % Q,
        (a[0] * b[1] + a[1] * b[0]) % Q,
    )


def h_fq2_inv(a):
    norm_inv = pow((a[0] * a[0] + a[1] * a[1]) % Q, Q - 2, Q)
    return ((a[0] * norm_inv) % Q, (-a[1] * norm_inv) % Q)


class _HostFq:
    def add(self, a, b):
        return (a + b) % Q

    def sub(self, a, b):
        return (a - b) % Q

    def mul(self, a, b):
        return (a * b) % Q

    def inv(self, a):
        return pow(a, Q - 2, Q)

    def zero(self):
        return 0

    def is_zero(self, a):
        return a == 0

    def neg(self, a):
        return (-a) % Q


class _HostFq2:
    def add(self, a, b):
        return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)

    def sub(self, a, b):
        return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)

    def mul(self, a, b):
        return h_fq2_mul(a, b)

    def inv(self, a):
        return h_fq2_inv(a)

    def zero(self):
        return (0, 0)

    def is_zero(self, a):
        return a == (0, 0)

    def neg(self, a):
        return ((-a[0]) % Q, (-a[1]) % Q)


HOST_FQ = _HostFq()
HOST_FQ2 = _HostFq2()


def h_ec_add(p, q, F=HOST_FQ):
    """Affine add; points are (x, y) or None for infinity."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if F.is_zero(F.add(y1, y2)):
            return None
        if F is HOST_FQ:
            lam = F.mul(F.mul(F.mul(x1, x1), 3), F.inv(F.mul(y1, 2)))
        else:
            three_x2 = F.mul(F.mul(x1, x1), (3, 0))
            lam = F.mul(three_x2, F.inv(F.add(y1, y1)))
        x3 = F.sub(F.sub(F.mul(lam, lam), x1), x2)
        y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
        return (x3, y3)
    lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
    x3 = F.sub(F.sub(F.mul(lam, lam), x1), x2)
    y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
    return (x3, y3)


def h_ec_mul(k: int, p, F=HOST_FQ):
    """Affine scalar multiply (double-and-add)."""
    acc = None
    add = p
    while k:
        if k & 1:
            acc = h_ec_add(acc, add, F)
        add = h_ec_add(add, add, F)
        k >>= 1
    return acc


def h_ec_mul_jac_f(k: int, p, F=HOST_FQ):
    """Field-generic Jacobian scalar multiply (G1 via HOST_FQ, G2 via
    HOST_FQ2) — one inversion total."""
    if p is None or k % R == 0:
        return None
    k %= R
    x2, y2 = p

    def dbl(X, Y, Z):
        A = F.mul(X, X)
        B = F.mul(Y, Y)
        C = F.mul(B, B)
        xb = F.add(X, B)
        D = F.sub(F.sub(F.mul(xb, xb), A), C)
        D = F.add(D, D)
        E = F.add(F.add(A, A), A)
        F_ = F.mul(E, E)
        X3 = F.sub(F_, F.add(D, D))
        C8 = F.add(C, C)
        C8 = F.add(C8, C8)
        C8 = F.add(C8, C8)
        Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
        Z3 = F.mul(F.add(Y, Y), Z)
        return X3, Y3, Z3

    def madd(X, Y, Z):
        ZZ = F.mul(Z, Z)
        U2 = F.mul(x2, ZZ)
        S2 = F.mul(F.mul(y2, Z), ZZ)
        H = F.sub(U2, X)
        r = F.sub(S2, Y)
        if F.is_zero(H):
            if F.is_zero(r):
                return dbl(X, Y, Z)
            return None
        HH = F.mul(H, H)
        HHH = F.mul(H, HH)
        V = F.mul(X, HH)
        X3 = F.sub(F.sub(F.mul(r, r), HHH), F.add(V, V))
        Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.mul(Y, HHH))
        Z3 = F.mul(Z, H)
        return X3, Y3, Z3

    one = (1, 0) if F is HOST_FQ2 else 1
    acc = None
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = dbl(*acc)
        if bit == "1":
            if acc is None:
                acc = (x2, y2, one)
            else:
                out = madd(*acc)
                if out is None:
                    return None
                acc = out
    if acc is None:
        return None
    X1, Y1, Z1 = acc
    zi = F.inv(Z1)
    zi2 = F.mul(zi, zi)
    return (F.mul(X1, zi2), F.mul(Y1, F.mul(zi2, zi)))


def h_on_curve_g1(p) -> bool:
    """y^2 = x^3 + 3 on python ints (None is the point at infinity)."""
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - B_G1) % Q == 0


def h_on_curve_g2(p) -> bool:
    """y^2 = x^3 + b2 over Fq2 on python ints (None is the point at infinity)."""
    if p is None:
        return True
    x, y = p
    y2 = h_fq2_mul(y, y)
    x3 = h_fq2_mul(h_fq2_mul(x, x), x)
    return ((y2[0] - x3[0] - B_G2[0]) % Q, (y2[1] - x3[1] - B_G2[1]) % Q) == (0, 0)
