"""Groth16 over BN254 — setup / prove / verify in the reference proof JSON
schema.  Port of eigen_zeth_tpu/models/groth16.py.

  * setup   host python ints, deterministic from a seed (a dev stand-in
            for a ceremony); the bulk queries use the host windowed
            fixed-base tables
  * prove   the G1/G2 MSMs of 64 points or more run on the device
            Pippenger (ops/msm.py: kernel B for every G1 add, kernel A for
            every Fq product); the QAP quotient is host NTT math over Fr
  * verify  host pairing: e(A,B) = e(α,β)·e(Σpubᵢ·ICᵢ, γ)·e(C,δ)

The same rng_seed gives the same proof JSON as the JAX package, byte for
byte: every MSM result is one unique point.

R1CS: constraints (A_row·w)(B_row·w) = (C_row·w), rows as {var: coeff}
dicts; variable 0 is the constant 1; variables 1..n_pub are public.
"""

from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass
from typing import Dict, List

from ..ops import msm, pairing
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
    out = []
    wj = 1
    d_inv = pow(d, R - 2, R)
    for _ in range(d):
        denom_inv = pow((tau - wj) % R, R - 2, R)
        out.append(wj * zt % R * d_inv % R * denom_inv % R)
        wj = wj * g % R
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


def batch_fixed_base(scalars, g2: bool = False) -> list:
    """[k·G for k in scalars] — affine host tuples, None at infinity."""
    scalars = [int(s) % R for s in scalars]
    if not scalars:
        return []
    if len(scalars) < 256:  # host double-and-add wins under the table overhead
        if g2:
            return [h_ec_mul_jac_f(s, G2_GEN, HOST_FQ2) if s else None for s in scalars]
        return [h_ec_mul_jac_f(s, G1_GEN) if s else None for s in scalars]
    return _host_fixed_base(scalars, g2)


def setup(r1cs: R1CS, seed: str = "ezt-groth16-dev") -> tuple[ProvingKey, VerifyingKey]:
    """Deterministic dev CRS (trusted-setup ceremony stand-in)."""
    alpha = _tau_from_seed(seed, "alpha")
    beta = _tau_from_seed(seed, "beta")
    gamma = _tau_from_seed(seed, "gamma")
    delta = _tau_from_seed(seed, "delta")
    tau = _tau_from_seed(seed, "tau")

    d = _domain_size(len(r1cs.constraints))
    lag = _lagrange_at(tau, d)
    nv = r1cs.num_vars
    a_tau = [0] * nv
    b_tau = [0] * nv
    c_tau = [0] * nv
    for j, (arow, brow, crow) in enumerate(r1cs.constraints):
        for v, coeff in arow.items():
            a_tau[v] = (a_tau[v] + coeff * lag[j]) % R
        for v, coeff in brow.items():
            b_tau[v] = (b_tau[v] + coeff * lag[j]) % R
        for v, coeff in crow.items():
            c_tau[v] = (c_tau[v] + coeff * lag[j]) % R

    gamma_inv = pow(gamma, R - 2, R)
    delta_inv = pow(delta, R - 2, R)
    zt = (pow(tau, d, R) - 1) % R

    def g1(k):
        return h_ec_mul_jac_f(k % R, G1_GEN) if k % R else None

    def g2(k):
        return h_ec_mul_jac_f(k % R, G2_GEN, HOST_FQ2) if k % R else None

    # bulk queries ride the windowed fixed-base tables; the handful of
    # single points stay host double-and-add
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
        a_query=batch_fixed_base(a_tau),
        b1_query=batch_fixed_base(b_tau),
        b2_query=batch_fixed_base(b_tau, g2=True),
        l_query=batch_fixed_base(l_scalars),
        h_query=batch_fixed_base(h_scalars),
        domain=d,
        num_public=r1cs.num_public,
    )
    vk = VerifyingKey(
        alpha1=g1(alpha),
        beta2=g2(beta),
        gamma2=g2(gamma),
        delta2=g2(delta),
        ic=batch_fixed_base(ic_scalars),
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


def _h_coeffs(r1cs: R1CS, w: List[int], d: int) -> list[int]:
    """Coefficients of h(x) = (a·b - c)/Z over the size-d domain —
    O(d log d) host NTTs (the round-1 O(d²) interpolation was fine at
    d ≤ 16 but the MiMC wrap runs at d = 2048)."""
    a_vals = [0] * d
    b_vals = [0] * d
    c_vals = [0] * d
    for j, (arow, brow, crow) in enumerate(r1cs.constraints):
        a_vals[j] = r1cs.eval_row(arow, w)
        b_vals[j] = r1cs.eval_row(brow, w)
        c_vals[j] = r1cs.eval_row(crow, w)

    ac, bc, cc = _fr_ntt(a_vals, True), _fr_ntt(b_vals, True), _fr_ntt(c_vals, True)

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


def prove(pk: ProvingKey, r1cs: R1CS, witness: List[int], rng_seed: str = "ezt-groth16-r",
          *, device) -> dict:
    """Groth16 prove; MSMs of MSM_DEVICE_THRESHOLD points or more run on
    `device`."""
    assert r1cs.is_satisfied(witness)
    r_rand = _tau_from_seed(rng_seed, "r")
    s_rand = _tau_from_seed(rng_seed, "s")

    def points_scalars(points, scalars):
        return [(p, s % R) for p, s in zip(points, scalars) if p is not None and s % R]

    def _host_msm(pairs, F=None):
        acc = None
        for p, s in pairs:
            term = h_ec_mul_jac_f(s, p, F or HOST_FQ)
            acc = h_ec_add(acc, term, F) if F else h_ec_add(acc, term)
        return acc

    def msm1(points, scalars):
        pairs = points_scalars(points, scalars)
        if not pairs:
            return None
        if len(pairs) < MSM_DEVICE_THRESHOLD:
            return _host_msm(pairs)
        return msm.msm_g1([p for p, _ in pairs], [s for _, s in pairs], device=device)

    def msm2(points, scalars):
        pairs = points_scalars(points, scalars)
        if not pairs:
            return None
        if len(pairs) < MSM_DEVICE_THRESHOLD:
            return _host_msm(pairs, HOST_FQ2)
        return msm.msm_g2([p for p, _ in pairs], [s for _, s in pairs], device=device)

    # A = α + Σ wᵢ·Aᵢ(τ) + r·δ
    pi_a = h_ec_add(pk.alpha1, msm1(pk.a_query, witness))
    pi_a = h_ec_add(pi_a, h_ec_mul(r_rand, pk.delta1))
    # B = β + Σ wᵢ·Bᵢ(τ) + s·δ  (G2, plus a G1 copy)
    pi_b = h_ec_add(pk.beta2, msm2(pk.b2_query, witness), HOST_FQ2)
    pi_b = h_ec_add(pi_b, h_ec_mul(s_rand, pk.delta2, HOST_FQ2), HOST_FQ2)
    pi_b1 = h_ec_add(pk.beta1, msm1(pk.b1_query, witness))
    pi_b1 = h_ec_add(pi_b1, h_ec_mul(s_rand, pk.delta1))
    # C = Σ_priv wᵢ·Lᵢ + Σ h_k·[τ^k Z/δ] + s·A + r·B₁ - r·s·δ
    priv = witness[pk.num_public + 1 :]
    h = _h_coeffs(r1cs, witness, pk.domain)
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
