"""Groth16 over BN254 — setup / prove / verify in the reference proof JSON
schema.  Port of eigen_zeth_tpu/models/groth16.py.

  * setup   deterministic from a seed (a dev stand-in for a ceremony);
            the QAP evaluations at tau are host python ints, the bulk
            queries windowed fixed-base tables: on the host for a small
            circuit, on the device for the in-circuit STARK verifier
            (gather and a tree of kernel B adds, G1 and G2; the queries
            then stay on the device as `DevicePoints`)
  * prove   the G1/G2 MSMs of 64 points or more run on the device
            Pippenger (ops/msm.py: kernel B for every G1 add, kernel A for
            every Fq product); the QAP quotient h runs its NTTs on the
            device (kernel A over the Fr MontCtx) for a CUDA device and on
            the host otherwise
  * verify  host pairing: e(A,B) = e(α,β)·e(Σpubᵢ·ICᵢ, γ)·e(C,δ)

The same rng_seed gives the same proof JSON as the JAX package, byte for
byte: every MSM result is one unique point.

R1CS: constraints (A_row·w)(B_row·w) = (C_row·w), rows as {var: coeff}
dicts; variable 0 is the constant 1; variables 1..n_pub are public.
"""

from __future__ import annotations

import functools
import hashlib
import multiprocessing
import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from ..ops import bn254, msm, pairing
from ..ops.bn254 import (
    G1_GEN,
    G2_GEN_X,
    G2_GEN_Y,
    HOST_FQ,
    HOST_FQ2,
    R,
    h_ec_add,
    h_ec_mul,
    h_ec_mul_jac_f,
)
from ..utils.profiling import span

G2_GEN = (G2_GEN_X, G2_GEN_Y)

# Pippenger pays off for large queries; below this many points the host
# double-and-add wins (the JAX package's threshold, kept).
MSM_DEVICE_THRESHOLD = 64


@dataclass
class R1CS:
    num_vars: int  # includes the constant-1 variable 0
    num_public: int  # public vars are 1..num_public
    constraints: List[tuple]  # (a_row, b_row, c_row) dicts {var: coeff}

    def eval_row(self, row: Dict[int, int], w: List[int]) -> int:
        return sum(c * w[v] for v, c in row.items()) % R

    def is_satisfied(self, w: List[int]) -> bool:
        assert len(w) == self.num_vars and w[0] == 1
        return all(
            self.eval_row(a, w) * self.eval_row(b, w) % R == self.eval_row(c, w)
            for a, b, c in self.constraints
        )


@dataclass
class ProvingKey:
    alpha1: tuple
    beta1: tuple
    beta2: tuple
    delta1: tuple
    delta2: tuple
    a_query: list  # [A_i(τ)]₁ per variable
    b1_query: list  # [B_i(τ)]₁
    b2_query: list  # [B_i(τ)]₂
    l_query: list  # [(βA_i+αB_i+C_i)(τ)/δ]₁ for private vars
    h_query: list  # [τ^k·Z(τ)/δ]₁
    domain: int
    num_public: int


@dataclass
class VerifyingKey:
    alpha1: tuple
    beta2: tuple
    gamma2: tuple
    delta2: tuple
    ic: list  # [(βA_i+αB_i+C_i)(τ)/γ]₁ for public vars (incl. constant)


@dataclass
class DevicePoints:
    """A CRS query kept on the device: affine coordinates as Montgomery
    limbs over Fq ((16, N) int32 for G1, (c0, c1) pairs of them for G2)
    and an (N,) bool infinity mask (coordinates (0, 0) there)."""

    x: object
    y: object
    inf: torch.Tensor
    g2: bool

    def __len__(self) -> int:
        return int(self.inf.shape[0])

    def to_host(self) -> list:
        """The JAX package's form: affine python-int tuples, None at infinity."""
        F = bn254.Fq2Ops() if self.g2 else bn254.FqOps()
        xs, ys = F.to_int(self.x), F.to_int(self.y)
        inf = self.inf.cpu().numpy()
        if self.g2:
            return [None if inf[i] else ((int(xs[0][i]), int(xs[1][i])),
                                         (int(ys[0][i]), int(ys[1][i])))
                    for i in range(len(inf))]
        return [None if inf[i] else (int(xs[i]), int(ys[i])) for i in range(len(inf))]


def _tau_from_seed(seed: str, tag: str) -> int:
    return (
        int.from_bytes(hashlib.sha256(f"{seed}/{tag}".encode()).digest() * 2, "big") % (R - 1)
    ) + 1


def _domain_size(n: int) -> int:
    d = 1
    while d < max(n, 2):
        d *= 2
    return d


def _lagrange_at(tau: int, d: int) -> list[int]:
    """L_j(τ) for the size-d roots-of-unity domain: ω_j(τ^d-1)/(d(τ-ω_j))."""
    # 2-adicity of r-1 covers d (r-1 = 2^28·odd)
    g = pow(5, (R - 1) // d, R)  # 5 generates Fr*
    zt = (pow(tau, d, R) - 1) % R
    ws = [1] * d
    for j in range(1, d):
        ws[j] = ws[j - 1] * g % R
    # the d inverses of (tau - w_j) by one batch inversion (tau is no root
    # of unity: it is a seed's hash); the same values as one Fermat power each
    dens = [(tau - w) % R for w in ws]
    assert all(dens)
    inv = _batch_inv(dens, R)
    c = zt * pow(d, R - 2, R) % R
    return [w * c % R * i % R for w, i in zip(ws, inv)]


def _batch_inv(vals: list, mod: int) -> list:
    """Inverses of nonzero values mod a prime (Montgomery's trick, one power)."""
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % mod
    acc = pow(prefix[n], mod - 2, mod)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = acc * prefix[i] % mod
        acc = acc * vals[i] % mod
    return out


# ---------------------------------------------------------------------------
# batch fixed-base scalar multiplication for the CRS: setup() needs k_i·G
# for ~4·num_vars individual scalars.  Windowed tables
#   T[w][d] = d·2^(c·w)·G   (built once with W·2^c host adds)
#   k·G     = Σ_w T[w][digit_w(k)]   (W Jacobian mixed adds per scalar)

FB_C = 8
FB_W = (254 + FB_C - 1) // FB_C  # 32 windows (power of two)


@functools.lru_cache(maxsize=2)
def _fb_table_host(g2: bool):
    """(W, 2^c) affine table rows; entry d=0 is None (infinity)."""
    base = G2_GEN if g2 else G1_GEN
    out = []
    step = base
    for _ in range(FB_W):
        row = [None, step]
        acc = step
        for _d in range(2, 1 << FB_C):
            acc = h_ec_add(acc, step, HOST_FQ2) if g2 else h_ec_add(acc, step)
            row.append(acc)
        out.append(row)
        step = h_ec_add(acc, step, HOST_FQ2) if g2 else h_ec_add(acc, step)
    return out


def _h_jac_dbl(F, X, Y, Z):
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


def _h_jac_madd(F, acc, aff):
    """Jacobian += affine (host, field-generic); acc None = infinity."""
    if aff is None:
        return acc
    x2, y2 = aff
    if acc is None:
        return (x2, y2, _h_one(F))
    X, Y, Z = acc
    Z1Z1 = F.mul(Z, Z)
    U2 = F.mul(x2, Z1Z1)
    S2 = F.mul(F.mul(y2, Z), Z1Z1)
    H = F.sub(U2, X)
    r = F.sub(S2, Y)
    if F.is_zero(H):
        if F.is_zero(r):
            return _h_jac_dbl(F, X, Y, Z)
        return None  # P + (-P)
    HH = F.mul(H, H)
    HHH = F.mul(H, HH)
    V = F.mul(X, HH)
    X3 = F.sub(F.sub(F.mul(r, r), HHH), F.add(V, V))
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.mul(Y, HHH))
    Z3 = F.mul(Z, H)
    return X3, Y3, Z3


def _h_one(F):
    return 1 if isinstance(F.zero(), int) else (1, 0)


def _host_fixed_base(scalars, g2: bool) -> list:
    """Host fixed-base: W Jacobian mixed-adds per scalar against the
    affine window table + ONE batched inversion — no XLA compiles (the
    CPU-backend path; the jitted gather/tree-reduce graph takes XLA CPU
    >20 min to compile cold)."""
    F = HOST_FQ2 if g2 else HOST_FQ
    table = _fb_table_host(g2)
    digits = msm.scalar_digits(scalars, c=FB_C)  # (W, N) numpy
    jacs = []
    for i in range(len(scalars)):
        acc = None
        for w in range(FB_W):
            d = int(digits[w, i])
            if d:
                acc = _h_jac_madd(F, acc, table[w][d])
        jacs.append(acc)
    # batched affine conversion: one field inversion total
    zs = [j[2] for j in jacs if j is not None]
    if not zs:
        return [None] * len(jacs)
    prefix = [_h_one(F)]
    for z in zs:
        prefix.append(F.mul(prefix[-1], z))
    total_inv = F.inv(prefix[-1])
    zinvs = [None] * len(zs)
    acc = total_inv
    for i in range(len(zs) - 1, -1, -1):
        zinvs[i] = F.mul(acc, prefix[i])
        acc = F.mul(acc, zs[i])
    out, k = [], 0
    for j in jacs:
        if j is None:
            out.append(None)
            continue
        X, Y, _ = j
        zi = zinvs[k]
        k += 1
        zi2 = F.mul(zi, zi)
        out.append((F.mul(X, zi2), F.mul(Y, F.mul(zi2, zi))))
    return out


def _h_jac_add(F, a, b):
    """Jacobian + Jacobian (host, field-generic), None = infinity."""
    if b is None:
        return a
    if a is None:
        return b
    X1, Y1, Z1 = a
    X2, Y2, Z2 = b
    Z1Z1 = F.mul(Z1, Z1)
    Z2Z2 = F.mul(Z2, Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    H = F.sub(U2, U1)
    r = F.sub(S2, S1)
    if F.is_zero(H):
        if F.is_zero(r):
            return _h_jac_dbl(F, X1, Y1, Z1)
        return None
    HH = F.mul(H, H)
    HHH = F.mul(H, HH)
    V = F.mul(U1, HH)
    X3 = F.sub(F.sub(F.mul(r, r), HHH), F.add(V, V))
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.mul(S1, HHH))
    Z3 = F.mul(F.mul(Z1, Z2), H)
    return X3, Y3, Z3


def host_pippenger(points, scalars, g2: bool = False, c: int = 13):
    """Host bucket-method MSM with Jacobian accumulation (the CPU path at
    circuit scale): W·N mixed adds and W·2^c bucket folds, one inversion."""
    F = HOST_FQ2 if g2 else HOST_FQ
    digits = msm.scalar_digits([int(s) % R for s in scalars], c=c)  # (W, N)
    n_windows = digits.shape[0]
    total = None  # Jacobian
    for w in range(n_windows - 1, -1, -1):
        if total is not None:
            for _ in range(c):
                total = _h_jac_dbl(F, *total)
        buckets = {}
        col = digits[w]
        for i, p in enumerate(points):
            d = int(col[i])
            if d and p is not None:
                buckets[d] = _h_jac_madd(F, buckets.get(d), p)
        # sum_d d*B_d by suffix sums: run accumulates the suffix of
        # buckets, acc accumulates run once per digit value
        acc = None
        if buckets:
            run = None
            for d in range(max(buckets), 0, -1):
                if d in buckets:
                    run = _h_jac_add(F, run, buckets[d])
                acc = _h_jac_add(F, acc, run)
        total = _h_jac_add(F, total, acc)
    if total is None:
        return None
    X, Y, Z = total
    zi = F.inv(Z)
    zi2 = F.mul(zi, zi)
    return (F.mul(X, zi2), F.mul(Y, F.mul(zi2, zi)))


# ---------------------------------------------------------------------------
# the device fixed-base (the JAX package's `_fb_gather_reduce`): the window
# table on the device, a gather of one entry per window and scalar, then a
# tree of log2(32) = 5 levels of complete adds (kernel B, or B's G2 form),
# and the affine conversion on the device (kernel A's power for the
# inverses).  FB_CHUNK scalars a pass bound the gathered planes (0.4 GB of
# G1 limbs); the JAX package passes 2^14, a size its compiler fixes.

FB_CHUNK = 1 << 16
FB_DEVICE_MIN = 1 << 13  # below this a host fixed-base (the JAX package's threshold)

_fb_tables: dict = {}


def _fb_table_device(g2: bool, device):
    """The (W·2^c) window table as Jacobian device points (d = 0 entries at
    infinity), made once per (group, device)."""
    key = (g2, torch.device(device))
    if key not in _fb_tables:
        flat = [e for row in _fb_table_host(g2) for e in row]
        make = msm._g2_device_points if g2 else msm._g1_device_points
        _fb_tables[key] = make(flat, device)
    return _fb_tables[key]


def _tree_map(fn, *trees):
    if isinstance(trees[0], tuple):
        return tuple(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def fixed_base_device(scalars, g2: bool, device, chunk: int = FB_CHUNK) -> DevicePoints:
    """[k·G for k in scalars] on `device` as DevicePoints: kernel B (G1) or
    its G2 form for the tree adds on a CUDA device, their plain versions on
    the CPU.  The scalars cross to the device once, as 32-bit limbs, and
    each pass takes its window digits there."""
    F = bn254.Fq2Ops() if g2 else bn254.FqOps()
    G = msm.ECGroup(F)
    table = _fb_table_device(g2, device)
    limbs = msm._limbs_tensor([int(s) % R for s in scalars], device)  # (n, 8)
    n = limbs.shape[0]
    chunk = min(chunk, max(1, n))
    window = torch.arange(FB_W, device=device)[:, None] * (1 << FB_C)
    xs, ys, infs = [], [], []
    for base in range(0, n, chunk):
        digits = msm.digits_from_limbs(limbs[base : base + chunk], c=FB_C)  # (W, k)
        k = digits.shape[1]
        idx = (window + digits).reshape(-1)
        pick = bn254.PointJ(*_tree_map(lambda l: l[:, idx].reshape(16, FB_W, k), tuple(table)))
        w = FB_W
        while w > 1:
            even = bn254.PointJ(*_tree_map(lambda l: l[:, 0::2], tuple(pick)))
            odd = bn254.PointJ(*_tree_map(lambda l: l[:, 1::2], tuple(pick)))
            pick = G.add(even, odd)
            w //= 2
        p = bn254.PointJ(*_tree_map(lambda l: l[:, 0], tuple(pick)))
        ax, ay = bn254.to_affine(F, p)
        xs.append(ax)
        ys.append(ay)
        infs.append(F.is_zero(p.z))
    cat = lambda *parts: torch.cat(parts, dim=-1)  # noqa: E731
    return DevicePoints(x=_tree_map(cat, *xs), y=_tree_map(cat, *ys),
                        inf=torch.cat(infs), g2=g2)


def batch_fixed_base(scalars, g2: bool = False, *, device):
    """[k·G for k in scalars]: affine host tuples (None at infinity), or
    DevicePoints when `device` is a CUDA device and the batch is large."""
    scalars = [int(s) % R for s in scalars]
    if not scalars:
        return []
    if len(scalars) < 256:  # host double-and-add wins under the table overhead
        if g2:
            return [h_ec_mul_jac_f(s, G2_GEN, HOST_FQ2) if s else None for s in scalars]
        return [h_ec_mul_jac_f(s, G1_GEN) if s else None for s in scalars]
    if torch.device(device).type == "cuda" and len(scalars) > FB_DEVICE_MIN:
        return fixed_base_device(scalars, g2, device)
    return _host_fixed_base(scalars, g2)


def setup(r1cs: R1CS, seed: str = "ezt-groth16-dev", *, device
          ) -> tuple[ProvingKey, VerifyingKey]:
    """Deterministic dev CRS (trusted-setup ceremony stand-in).  With a
    CUDA `device` the large queries are made, and stay, on the device."""
    alpha = _tau_from_seed(seed, "alpha")
    beta = _tau_from_seed(seed, "beta")
    gamma = _tau_from_seed(seed, "gamma")
    delta = _tau_from_seed(seed, "delta")
    tau = _tau_from_seed(seed, "tau")

    d = _domain_size(len(r1cs.constraints))
    on_card = torch.device(device).type == "cuda"
    lag = _lagrange_at_device(tau, d, device) if on_card else _lagrange_at(tau, d)
    nv = r1cs.num_vars
    a_tau = [0] * nv
    b_tau = [0] * nv
    c_tau = [0] * nv
    for part in _over_ranges(_sums_at_tau, len(r1cs.constraints), (r1cs, lag)):
        for acc, sums in zip((a_tau, b_tau, c_tau), part):
            for v, t in sums.items():
                acc[v] += t
    a_tau = [v % R for v in a_tau]
    b_tau = [v % R for v in b_tau]
    c_tau = [v % R for v in c_tau]

    gamma_inv = pow(gamma, R - 2, R)
    delta_inv = pow(delta, R - 2, R)
    zt = (pow(tau, d, R) - 1) % R

    def g1(k):
        return h_ec_mul_jac_f(k % R, G1_GEN) if k % R else None

    def g2(k):
        return h_ec_mul_jac_f(k % R, G2_GEN, HOST_FQ2) if k % R else None

    # bulk queries ride the windowed fixed-base tables; the handful of
    # single points stay host double-and-add
    fb = functools.partial(batch_fixed_base, device=device)
    l_scalars = [
        (beta * a_tau[i] + alpha * b_tau[i] + c_tau[i]) * delta_inv % R
        for i in range(r1cs.num_public + 1, nv)
    ]
    h_scalars, tp = [], 1
    zt_d = zt * delta_inv % R
    for _ in range(d - 1):
        h_scalars.append(tp * zt_d % R)
        tp = tp * tau % R
    ic_scalars = [
        (beta * a_tau[i] + alpha * b_tau[i] + c_tau[i]) * gamma_inv % R
        for i in range(r1cs.num_public + 1)
    ]
    pk = ProvingKey(
        alpha1=g1(alpha),
        beta1=g1(beta),
        beta2=g2(beta),
        delta1=g1(delta),
        delta2=g2(delta),
        a_query=fb(a_tau),
        b1_query=fb(b_tau),
        b2_query=fb(b_tau, g2=True),
        l_query=fb(l_scalars),
        h_query=fb(h_scalars),
        domain=d,
        num_public=r1cs.num_public,
    )
    vk = VerifyingKey(
        alpha1=g1(alpha),
        beta2=g2(beta),
        gamma2=g2(gamma),
        delta2=g2(delta),
        ic=batch_fixed_base(ic_scalars, device="cpu"),  # the VK holds host points
    )
    return pk, vk


def _fr_ntt(vals: list[int], inverse: bool = False) -> list[int]:
    """Iterative radix-2 NTT over Fr (host ints).  r-1 = 2^28·odd covers
    every wrap-circuit domain; 5 generates Fr*."""
    n = len(vals)
    assert n & (n - 1) == 0
    a = list(vals)
    # bit-reversal permutation
    bits = n.bit_length() - 1
    for i in range(n):
        j = int(bin(i)[2:].zfill(bits)[::-1], 2)
        if i < j:
            a[i], a[j] = a[j], a[i]
    size = 2
    while size <= n:
        w = pow(5, (R - 1) // size, R)
        if inverse:
            w = pow(w, R - 2, R)
        half = size // 2
        for base in range(0, n, size):
            wj = 1
            for k in range(half):
                lo = a[base + k]
                hi = a[base + k + half] * wj % R
                a[base + k] = (lo + hi) % R
                a[base + k + half] = (lo - hi) % R
                wj = wj * w % R
        size *= 2
    if inverse:
        n_inv = pow(n, R - 2, R)
        a = [x * n_inv % R for x in a]
    return a


def _row_values(r1cs: R1CS, w: List[int]) -> tuple:
    """(A·w, B·w, C·w) of every constraint, each as the values' 32-byte
    little-endian words joined in one bytes object; raises AssertionError
    if a constraint is not satisfied."""
    parts = _over_ranges(_values_at_w, len(r1cs.constraints), (r1cs, w))
    return tuple(b"".join(p[k] for p in parts) for k in range(3))


def _ints(words: bytes) -> list[int]:
    """A bytes object of 32-byte little-endian words -> the python ints."""
    return [int.from_bytes(words[i : i + 32], "little") for i in range(0, len(words), 32)]


# The passes over a large circuit's constraints (the rows' values at the
# witness in prove, their sums at tau in setup) run in forked host
# processes, a contiguous range of constraints each: the STARK wrap's
# circuit has millions.  A forked worker inherits the circuit without a
# copy; it runs only Python int math and touches neither torch nor CUDA, so
# the parent's CUDA context and thread pools are never used after the
# fork.  Each worker pickles its results back (about 1.1 GB of row values
# for the production wrap).  HOST_WORKERS: the H100 hosts measured have 8
# cores.  Building the rows once per circuit shape as arrays would make the
# fork unnecessary (ROADMAP M4).
HOST_WORKERS = max(1, min(8, os.cpu_count() or 1))
PARALLEL_MIN = 1 << 18  # constraints below which one process makes the pass
_WORKER_SHARED = None  # in a forked worker only: the pass's shared inputs


def _init_worker(shared) -> None:
    global _WORKER_SHARED
    _WORKER_SHARED = shared


def _in_worker(fn, lo: int, hi: int):
    return fn(_WORKER_SHARED, lo, hi)


def _over_ranges(fn, n: int, shared) -> list:
    """[fn(shared, lo, hi) for the ranges of 0..n], one range a worker
    process, or one range in this process for a small n.  `shared` reaches
    the workers through the fork, never through a global of this process,
    so passes of two provers in one process do not meet."""
    if n < PARALLEL_MIN or HOST_WORKERS < 2:
        return [fn(shared, 0, n)]
    step = -(-n // HOST_WORKERS)
    ranges = [(fn, lo, min(lo + step, n)) for lo in range(0, n, step)]
    with multiprocessing.get_context("fork").Pool(
            len(ranges), initializer=_init_worker, initargs=(shared,)) as pool:
        return pool.starmap(_in_worker, ranges)


def _values_at_w(shared: tuple, lo: int, hi: int) -> tuple:
    """(A·w, B·w, C·w) of constraints lo..hi as joined 32-byte words, each
    constraint checked: a·b = c.  A row object that several places share
    (the circuit builder reuses rows) is evaluated once."""
    r1cs, w = shared
    seen: dict = {}

    def value(row):
        key = id(row)
        if key not in seen:
            seen[key] = r1cs.eval_row(row, w)
        return seen[key]

    rows = r1cs.constraints[lo:hi]
    a, b, c = [value(x) for x, _, _ in rows], [value(x) for _, x, _ in rows], [
        value(x) for _, _, x in rows]
    assert all(x * y % R == z for x, y, z in zip(a, b, c)), "unsatisfied R1CS"
    return tuple(b"".join(v.to_bytes(32, "little") for v in vals) for vals in (a, b, c))


def _sums_at_tau(shared: tuple, lo: int, hi: int) -> tuple:
    """{var: Σ_j coeff·L_j(tau)} over constraints lo..hi for A, B and C,
    reduced mod R once at the end; a row shared by A and B (an S-box's x·x)
    multiplies once."""
    r1cs, lag = shared
    a, b, c = {}, {}, {}
    for j in range(lo, hi):
        arow, brow, crow = r1cs.constraints[j]
        lj = lag[j]
        if arow is brow:
            for v, coeff in arow.items():
                t = coeff * lj
                a[v] = a.get(v, 0) + t
                b[v] = b.get(v, 0) + t
        else:
            for v, coeff in arow.items():
                a[v] = a.get(v, 0) + coeff * lj
            for v, coeff in brow.items():
                b[v] = b.get(v, 0) + coeff * lj
        for v, coeff in crow.items():
            c[v] = c.get(v, 0) + coeff * lj
    return tuple({v: t % R for v, t in d.items()} for d in (a, b, c))


def _h_from_values(a_rows: bytes, b_rows: bytes, c_rows: bytes, d: int) -> list[int]:
    """Coefficients of h(x) = (a·b - c)/Z over the size-d domain from the
    constraints' row values (`_row_values`): O(d log d) host NTTs (the
    plain form)."""
    ac, bc, cc = (_fr_ntt(_ints(v) + [0] * (d - len(v) // 32), True)
                  for v in (a_rows, b_rows, c_rows))

    # evaluate on a coset (shift s) and divide by Z(sx) = s^d·x^d - 1
    s = 7
    s_pows = [1] * d
    for k in range(1, d):
        s_pows[k] = s_pows[k - 1] * s % R
    av = _fr_ntt([c * p % R for c, p in zip(ac, s_pows)])
    bv = _fr_ntt([c * p % R for c, p in zip(bc, s_pows)])
    cv = _fr_ntt([c * p % R for c, p in zip(cc, s_pows)])
    zs_inv = pow((pow(s, d, R) - 1) % R, R - 2, R)  # Z on coset is constant
    h_vals = [(a_ * b_ - c_) % R * zs_inv % R for a_, b_, c_ in zip(av, bv, cv)]
    hc_shift = _fr_ntt(h_vals, True)
    s_inv = pow(s, R - 2, R)
    si = 1
    out = []
    for k in range(d):
        out.append(hc_shift[k] * si % R)
        si = si * s_inv % R
    return out


def _h_coeffs(r1cs: R1CS, w: List[int], d: int) -> list[int]:
    """The JAX package's `_h_coeffs`: h's coefficients by host NTTs."""
    return _h_from_values(*_row_values(r1cs, w), d)


# ---------------------------------------------------------------------------
# h on the device: the same seven NTTs over the Fr MontCtx, every product
# kernel A (its plain version on the CPU)


def _fr_powers(ctx, base: int, n: int, device) -> torch.Tensor:
    """(16, n) Montgomery limbs of base^0 .. base^(n-1), by doubling: each
    step multiplies the table so far by base^len (one product launch)."""
    t = ctx.const_mont(1, (1,), device)
    while t.shape[1] < n:
        k = t.shape[1]
        step = ctx.const_mont(pow(base, k, R), (1,), device)
        t = torch.cat([t, ctx.mont_mul(t, step.expand(16, k).contiguous())], dim=1)
    return t[:, :n].contiguous()


def _fr_limbs(words: bytes, n: int, device) -> torch.Tensor:
    """Canonical values as joined 32-byte words, zero-padded to n ->
    (16, n) Montgomery limbs on `device`: the raw limbs cross, one product
    by R^2 on the device converts."""
    ctx = bn254.fr()
    limbs = np.zeros((n, 16), dtype=np.int32)
    k = len(words) // 32
    limbs[:k] = np.frombuffer(words, dtype="<u2").reshape(k, 16)
    x = torch.from_numpy(np.ascontiguousarray(limbs.T)).to(device)
    return ctx.mont_mul(x, ctx.from_int([ctx.R2_mod], device, mont=False).expand_as(x).contiguous())


def _regular_limbs(ctx, x: torch.Tensor) -> torch.Tensor:
    """(16, n) Montgomery limbs -> the regular values' limbs (one product by 1)."""
    return ctx.mont_mul(x, ctx.from_int([1], x.device, mont=False).expand_as(x).contiguous())


def _scalar_words(limbs: torch.Tensor) -> torch.Tensor:
    """(16, n) regular 16-bit limbs -> (n, 8) int64 32-bit limbs: the
    scalars' form that the MSM takes."""
    x = limbs.to(torch.int64)
    return (x[0::2] | (x[1::2] << 16)).T.contiguous()


def _lagrange_at_device(tau: int, d: int, device) -> list[int]:
    """`_lagrange_at` on `device`: the powers of the root by doubling, the
    inverses of (tau - w_j) by one Fermat power each (kernel A's power),
    the same values as host ints."""
    ctx = bn254.fr()
    ws = _fr_powers(ctx, pow(5, (R - 1) // d, R), d, device)
    dens = ctx.sub(ctx.const_mont(tau, (d,), device), ws)
    if bool(ctx.is_zero(dens).any()):
        raise AssertionError("tau is a root of unity of the domain")
    zt = (pow(tau, d, R) - 1) % R
    c = ctx.const_mont(zt * pow(d, R - 2, R) % R, (d,), device)
    out = ctx.mont_mul(ctx.mont_mul(ws, c), ctx.inv(dens))
    return [int(v) for v in ctx.to_int(_regular_limbs(ctx, out), mont=False)]


def _fr_ntt_device(ctx, x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Radix-2 NTT of (16, d) Montgomery limbs in natural order, the host
    `_fr_ntt` butterfly for butterfly.  table: (16, d/2) powers of the
    size-d root (its inverse for the inverse transform; the caller scales)."""
    d = x.shape[1]
    bits = d.bit_length() - 1
    idx = torch.arange(d, device=x.device)
    rev = torch.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    a = x[:, rev]
    size = 2
    while size <= d:
        half = size // 2
        tw = table[:, :: d // size][:, :half]  # the size-th root's powers
        a = a.reshape(16, d // size, 2, half)
        lo = a[:, :, 0]
        hi = ctx.mont_mul(a[:, :, 1], tw[:, None, :])
        a = torch.stack([ctx.add(lo, hi), ctx.sub(lo, hi)], dim=2).reshape(16, d)
        size *= 2
    return a


def _h_from_values_device(a_rows: bytes, b_rows: bytes, c_rows: bytes, d: int, device,
                          as_scalars: bool = False):
    """`_h_from_values` on `device`: the same coefficients, as host ints, or
    with as_scalars as the MSM's (d, 8) device limbs."""
    ctx = bn254.fr()
    w = pow(5, (R - 1) // d, R)
    fwd = _fr_powers(ctx, w, max(1, d // 2), device)
    inv = _fr_powers(ctx, pow(w, R - 2, R), max(1, d // 2), device)
    s = 7
    s_pows = _fr_powers(ctx, s, d, device)
    s_inv_pows = _fr_powers(ctx, pow(s, R - 2, R), d, device)
    n_inv = ctx.const_mont(pow(d, R - 2, R), (1,), device)

    def coeffs_on_coset(vals):
        x = _fr_limbs(vals, d, device)
        c = ctx.mont_mul(_fr_ntt_device(ctx, x, inv), n_inv.expand(16, d).contiguous())
        return _fr_ntt_device(ctx, ctx.mont_mul(c, s_pows), fwd)

    av, bv, cv = (coeffs_on_coset(v) for v in (a_rows, b_rows, c_rows))
    zs_inv = ctx.const_mont(pow((pow(s, d, R) - 1) % R, R - 2, R), (1,), device)
    h_vals = ctx.mont_mul(ctx.sub(ctx.mont_mul(av, bv), cv), zs_inv.expand(16, d).contiguous())
    hc = ctx.mont_mul(_fr_ntt_device(ctx, h_vals, inv), n_inv.expand(16, d).contiguous())
    out = _regular_limbs(ctx, ctx.mont_mul(hc, s_inv_pows))
    if as_scalars:
        return _scalar_words(out)
    return [int(v) for v in ctx.to_int(out, mont=False)]


def prove(pk: ProvingKey, r1cs: R1CS, witness: List[int], rng_seed: str = "ezt-groth16-r",
          *, device) -> dict:
    """Groth16 prove.  MSMs of MSM_DEVICE_THRESHOLD points or more run on
    a CUDA device's Pippenger, and the QAP quotient's NTTs too; on the CPU
    they run the host Pippenger.  Queries held as DevicePoints are
    multiplied where they lie."""
    assert len(witness) == r1cs.num_vars and witness[0] == 1
    with span("step4.witness"):  # the witness's row values
        a_rows, b_rows, c_rows = _row_values(r1cs, witness)  # checks every constraint
    r_rand = _tau_from_seed(rng_seed, "r")
    s_rand = _tau_from_seed(rng_seed, "s")
    on_card = torch.device(device).type == "cuda"

    def points_scalars(points, scalars):
        return [(p, s % R) for p, s in zip(points, scalars) if p is not None and s % R]

    def _host_msm(pairs, F=None):
        acc = None
        for p, s in pairs:
            term = h_ec_mul_jac_f(s, p, F or HOST_FQ)
            acc = h_ec_add(acc, term, F) if F else h_ec_add(acc, term)
        return acc

    w_dev = []  # the witness as the MSM's device limbs, made once for the device queries

    def msm_any(points, scalars, g2: bool):
        if isinstance(points, DevicePoints):
            if scalars is witness or scalars is priv:
                if not w_dev:
                    w_dev.append(msm._limbs_tensor(witness, points.inf.device))
                scalars = w_dev[0][len(witness) - len(scalars):]  # the witness or its tail
            return msm.msm_affine(points.x, points.y, points.inf, scalars[: len(points)], g2=g2)
        pairs = points_scalars(points, scalars)
        if not pairs:
            return None
        if len(pairs) < MSM_DEVICE_THRESHOLD:
            return _host_msm(pairs, HOST_FQ2 if g2 else None)
        if not on_card:
            # the host Pippenger, as the JAX package's CPU path runs its
            # large MSMs: the device schedule's plain versions take a
            # minute at the MiMC wrap's 1,326 points, hours at the STARK
            # wrap's; a window of about log2(n) - 3 bits
            c = max(4, min(13, len(pairs).bit_length() - 3))
            return host_pippenger([p for p, _ in pairs], [s for _, s in pairs], g2=g2, c=c)
        run = msm.msm_g2 if g2 else msm.msm_g1
        return run([p for p, _ in pairs], [s for _, s in pairs], device=device)

    def msm1(points, scalars):
        with span("step4.msm", g2=False):
            return msm_any(points, scalars, False)

    def msm2(points, scalars):
        with span("step4.msm", g2=True):
            return msm_any(points, scalars, True)

    priv = witness[pk.num_public + 1 :]
    # A = α + Σ wᵢ·Aᵢ(τ) + r·δ
    pi_a = h_ec_add(pk.alpha1, msm1(pk.a_query, witness))
    pi_a = h_ec_add(pi_a, h_ec_mul(r_rand, pk.delta1))
    # B = β + Σ wᵢ·Bᵢ(τ) + s·δ  (G2, plus a G1 copy)
    pi_b = h_ec_add(pk.beta2, msm2(pk.b2_query, witness), HOST_FQ2)
    pi_b = h_ec_add(pi_b, h_ec_mul(s_rand, pk.delta2, HOST_FQ2), HOST_FQ2)
    pi_b1 = h_ec_add(pk.beta1, msm1(pk.b1_query, witness))
    pi_b1 = h_ec_add(pi_b1, h_ec_mul(s_rand, pk.delta1))
    # C = Σ_priv wᵢ·Lᵢ + Σ h_k·[τ^k Z/δ] + s·A + r·B₁ - r·s·δ
    with span("step4.h"):
        if on_card:
            h = _h_from_values_device(a_rows, b_rows, c_rows, pk.domain, device,
                                      as_scalars=isinstance(pk.h_query, DevicePoints))
        else:
            h = _h_from_values(a_rows, b_rows, c_rows, pk.domain)
    pi_c = msm1(pk.l_query, priv)
    pi_c = h_ec_add(pi_c, msm1(pk.h_query, h[: len(pk.h_query)]))
    pi_c = h_ec_add(pi_c, h_ec_mul(s_rand, pi_a))
    pi_c = h_ec_add(pi_c, h_ec_mul(r_rand, pi_b1))
    pi_c = h_ec_add(pi_c, h_ec_mul(R - (r_rand * s_rand) % R, pk.delta1))
    return encode_proof(pi_a, pi_b, pi_c)


def verify(vk: VerifyingKey, proof: dict, public_inputs: List[int]) -> bool:
    try:
        pi_a, pi_b, pi_c = decode_proof(proof)
    except (KeyError, ValueError):
        return False
    if proof.get("protocol") != "groth16" or proof.get("curve") != "BN128":
        return False
    assert len(public_inputs) == len(vk.ic) - 1
    acc = vk.ic[0]
    for x, p in zip(public_inputs, vk.ic[1:]):
        acc = h_ec_add(acc, h_ec_mul(x % R, p))
    lhs = pairing.pairing(pi_a, pi_b)
    rhs = pairing.f12_mul(
        pairing.pairing(vk.alpha1, vk.beta2),
        pairing.f12_mul(
            pairing.pairing(acc, vk.gamma2), pairing.pairing(pi_c, vk.delta2)
        ),
    )
    return lhs == rhs


# ---------------------------------------------------------------------------
# reference-schema proof JSON (parity with proof/proof.json)


def encode_proof(pi_a, pi_b, pi_c) -> dict:
    """Affine points -> the reference's exact JSON schema (decimal strings,
    pi_b coordinates as [c0, c1] arrays)."""
    return {
        "pi_a": {"x": str(pi_a[0]), "y": str(pi_a[1])},
        "pi_b": {
            "x": [str(pi_b[0][0]), str(pi_b[0][1])],
            "y": [str(pi_b[1][0]), str(pi_b[1][1])],
        },
        "pi_c": {"x": str(pi_c[0]), "y": str(pi_c[1])},
        "protocol": "groth16",
        "curve": "BN128",
    }


def decode_proof(proof: dict):
    pi_a = (int(proof["pi_a"]["x"]), int(proof["pi_a"]["y"]))
    pi_b = (
        (int(proof["pi_b"]["x"][0]), int(proof["pi_b"]["x"][1])),
        (int(proof["pi_b"]["y"][0]), int(proof["pi_b"]["y"][1])),
    )
    pi_c = (int(proof["pi_c"]["x"]), int(proof["pi_c"]["y"]))
    return pi_a, pi_b, pi_c


# ---------------------------------------------------------------------------
# the final-wrap circuit: bind the aggregated digest to the public input


def wrap_circuit() -> R1CS:
    """The small ('linear') wrap: public x₁; private h₀..h₃ (aggregated
    Poseidon digest limbs) and t = h₀·h₁.  Constraints:
      1:  (h₀)·(h₁) = t                       [quadratic binding]
      2:  (x₁ - h₀ - 2^64·h₁ - 2^128·h₂ - 2^192·h₃)·(1) = 0
    so the Groth16 public input IS the packed aggregated digest.
    Used by CPU test profiles; production uses mimc_wrap_circuit."""
    c1 = ({2: 1}, {3: 1}, {6: 1})
    lin = {1: 1, 2: R - 1, 3: (R - (1 << 64)) % R, 4: (R - (1 << 128)) % R, 5: (R - (1 << 192)) % R}
    c2 = (lin, {0: 1}, {0: 0})
    return R1CS(num_vars=7, num_public=1, constraints=[c1, c2])


def wrap_witness(digest: List[int]) -> tuple[List[int], int]:
    """digest: 4 Goldilocks elements -> (witness, public_input)."""
    h0, h1, h2, h3 = [int(x) for x in digest]
    pub = (h0 + (h1 << 64) + (h2 << 128) + (h3 << 192)) % R
    t = h0 * h1 % R
    return [1, pub, h0, h1, h2, h3, t], pub


# ---------------------------------------------------------------------------
# the production wrap: MiMC-x⁵ sponge over Fr computed in-circuit

MIMC_ROUNDS = 110  # ceil(254 / log2(5)) — full algebraic degree in Fr


@dataclass
class _MimcWrap:
    r1cs: R1CS
    limb_vars: list  # var ids of h0..h3
    round_vars: list  # per (limb, round): (u2, u4, out) var ids


def _mimc_constants() -> list[int]:
    return [
        int.from_bytes(
            hashlib.sha256(f"ezt-mimc-fr/{j}".encode()).digest() * 2, "big"
        ) % R
        for j in range(MIMC_ROUNDS)
    ]


def mimc_hash_host(limbs: List[int]) -> int:
    """Miyaguchi–Preneel over the MiMC-x⁵ permutation:
    s ← perm(s + m) + s + m, starting from s = 0."""
    cs = _mimc_constants()
    s = 0
    for m in limbs:
        x = (s + int(m)) % R
        t = x
        for c in cs:
            t = pow((t + c) % R, 5, R)
        s = (t + x) % R
    return s


@functools.lru_cache(maxsize=1)
def mimc_wrap_circuit() -> _MimcWrap:
    """R1CS computing x₁ = MiMC-hash(h₀..h₃).

    Per round, with u = t + c_j (linear): u2 = u·u, u4 = u2·u2,
    t' = u4·u — 3 constraints of degree 2.  4 limbs × 110 rounds × 3
    + the final public equality = 1321 constraints, 1326 variables."""
    cs = _mimc_constants()
    cons: List[tuple] = []
    nv = 2  # 0 = const, 1 = public hash
    limb_vars = [nv + i for i in range(4)]
    nv += 4
    round_vars = []

    def new_var():
        nonlocal nv
        nv += 1
        return nv - 1

    # t is tracked as a LINEAR ROW {var: coeff, 0: const} over the witness
    s_row = {0: 0}  # s = 0
    for li in range(4):
        # x = s + m_li
        x_row = dict(s_row)
        x_row[limb_vars[li]] = (x_row.get(limb_vars[li], 0) + 1) % R
        t_row = dict(x_row)
        for j, c in enumerate(cs):
            u_row = dict(t_row)
            u_row[0] = (u_row.get(0, 0) + c) % R
            u2 = new_var()
            u4 = new_var()
            out = new_var()
            cons.append((u_row, u_row, {u2: 1}))
            cons.append(({u2: 1}, {u2: 1}, {u4: 1}))
            cons.append(({u4: 1}, u_row, {out: 1}))
            round_vars.append((u2, u4, out))
            t_row = {out: 1}
        # s' = perm_out + s + m  (linear)
        s_row = dict(x_row)
        s_row[t_row_key(t_row)] = (s_row.get(t_row_key(t_row), 0) + 1) % R
    # public equality: (x1 - s)·1 = 0
    eq = {1: 1}
    for v, coeff in s_row.items():
        eq[v] = (eq.get(v, 0) - coeff) % R
    cons.append((eq, {0: 1}, {0: 0}))
    return _MimcWrap(
        r1cs=R1CS(num_vars=nv, num_public=1, constraints=cons),
        limb_vars=limb_vars,
        round_vars=round_vars,
    )


def t_row_key(t_row: dict) -> int:
    (v, c), = t_row.items()
    assert c == 1
    return v


def mimc_wrap_witness(digest: List[int]) -> tuple[List[int], int]:
    """digest: 4 Goldilocks elements -> (witness, public_input = MiMC
    hash).  Re-runs the hash collecting every round intermediate."""
    wrap = mimc_wrap_circuit()
    cs = _mimc_constants()
    w = [0] * wrap.r1cs.num_vars
    w[0] = 1
    limbs = [int(x) % R for x in digest]
    for var, val in zip(wrap.limb_vars, limbs):
        w[var] = val
    s = 0
    k = 0
    for m in limbs:
        x = (s + m) % R
        t = x
        for c in cs:
            u = (t + c) % R
            u2 = u * u % R
            u4 = u2 * u2 % R
            t = u4 * u % R
            v2, v4, vo = wrap.round_vars[k]
            w[v2], w[v4], w[vo] = u2, u4, t
            k += 1
        s = (t + x) % R
    w[1] = s
    assert s == mimc_hash_host(limbs)
    return w, s
