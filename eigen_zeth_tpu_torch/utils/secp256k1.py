"""secp256k1 — signing, recovery, and Ethereum addresses (host-side).

The reference gets this from the `ethers` signer stack (local wallets,
src/settlement/ethereum/mod.rs:97-120) and from revm's secp256k1 for tx
sender recovery (SURVEY.md §2.9-bis "keccak/secp256k1 in revm").  Here it
is a from-scratch host implementation, a copy of
eigen_zeth_tpu/utils/secp256k1.py whose scalar product works in Jacobian
coordinates (its results are the affine chain's): signature work is
scalar, branchy bigint math, so it stays on the host (the device path is
the field and curve bulk math in ops/).

Provides:
  * sign(digest, priv)        -> (y_parity, r, s)  with RFC 6979
                                 deterministic nonces and low-s
  * recover(digest, yp, r, s) -> affine public key point (ecrecover)
  * priv_to_address / pub_to_address
  * EIP-155 v encoding helpers
"""

from __future__ import annotations

import hashlib
import hmac

from ..ops import keccak

# Curve: y^2 = x^3 + 7 over F_P; group order N.
P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G = (GX, GY)


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def ec_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def _jac_double(p):
    """2p in Jacobian coordinates (None: the point at infinity); y = 0 gives
    infinity, as ec_add(p, p) does."""
    if p is None:
        return None
    x, y, z = p
    if y % P == 0:
        return None
    a, b = x * x % P, y * y % P
    c = b * b % P
    d = 2 * ((x + b) * (x + b) - a - c) % P
    e = 3 * a % P
    x3 = (e * e - 2 * d) % P
    return (x3, (e * (d - x3) - 8 * c) % P, 2 * y * z % P)


def _jac_add(p, q):
    """p + q in Jacobian coordinates, with ec_add's cases: equal x gives
    infinity when y1 + y2 = 0 and doubles p otherwise."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = z1 * z1 % P, z2 * z2 % P
    u1, u2 = x1 * z2z2 % P, x2 * z1z1 % P
    s1, s2 = y1 * z2 * z2z2 % P, y2 * z1 * z1z1 % P
    if u1 == u2:
        return None if (s1 + s2) % P == 0 else _jac_double(p)
    h, r = (u2 - u1) % P, (s2 - s1) % P
    hh = h * h % P
    hhh, v = h * hh % P, u1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    return (x3, (r * (v - x3) - s1 * hhh) % P, h * z1 * z2 % P)


def ec_mul(k: int, p):
    """k·p by double-and-add from the low bit, as the affine ec_add chain
    would do it, in Jacobian coordinates: one inversion in all, not one an
    addition; the affine result is the same."""
    acc, add = None, (p[0], p[1], 1)
    while k:
        if k & 1:
            acc = _jac_add(acc, add)
        add = _jac_double(add)
        k >>= 1
    if acc is None:
        return None
    x, y, z = acc
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def priv_to_pub(priv: int):
    return ec_mul(priv % N, G)


def pub_to_address(pub) -> str:
    x, y = pub
    raw = x.to_bytes(32, "big") + y.to_bytes(32, "big")
    return "0x" + keccak.keccak256_host(raw)[12:].hex()


def priv_to_address(priv: int) -> str:
    return pub_to_address(priv_to_pub(priv))


def _rfc6979_k(digest: bytes, priv: int) -> int:
    """Deterministic nonce per RFC 6979 (HMAC-SHA256)."""
    x = priv.to_bytes(32, "big")
    h1 = digest
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(digest: bytes, priv: int) -> tuple[int, int, int]:
    """ECDSA over a 32-byte digest -> (y_parity, r, s) with low-s."""
    assert len(digest) == 32
    z = int.from_bytes(digest, "big")
    priv %= N
    while True:
        k = _rfc6979_k(digest, priv)
        R = ec_mul(k, G)
        r = R[0] % N
        if r == 0:
            digest = keccak.keccak256_host(digest)
            continue
        s = _inv(k, N) * (z + r * priv) % N
        if s == 0:
            digest = keccak.keccak256_host(digest)
            continue
        y_parity = R[1] & 1
        if s > N // 2:  # low-s normalization (EIP-2)
            s = N - s
            y_parity ^= 1
        return y_parity, r, s


def recover(digest: bytes, y_parity: int, r: int, s: int):
    """ecrecover: public key point, or None if the signature is invalid."""
    if not (1 <= r < N and 1 <= s < N):
        return None
    x = r  # r < N < P: no x + N candidates needed for practical txs
    y_sq = (pow(x, 3, P) + 7) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if y * y % P != y_sq:
        return None
    if y & 1 != y_parity & 1:
        y = P - y
    z = int.from_bytes(digest, "big")
    r_inv = _inv(r, N)
    # Q = r^-1 (s·R - z·G)
    u1 = (-z * r_inv) % N
    u2 = (s * r_inv) % N
    q = ec_add(ec_mul(u1, G), ec_mul(u2, (x, y)))
    return q


def recover_address(digest: bytes, y_parity: int, r: int, s: int):
    pub = recover(digest, y_parity, r, s)
    return pub_to_address(pub) if pub else None


# --- EIP-155 v encoding ----------------------------------------------------


def v_from_parity(y_parity: int, chain_id: int | None) -> int:
    """Legacy-tx v: 27/28 pre-155, 35 + 2·chain_id + parity with replay
    protection."""
    if chain_id is None:
        return 27 + y_parity
    return 35 + 2 * chain_id + y_parity


def parity_from_v(v: int) -> tuple[int, int | None]:
    """v -> (y_parity, chain_id or None)."""
    if v in (27, 28):
        return v - 27, None
    if v >= 35:
        chain_id = (v - 35) // 2
        return (v - 35) % 2, chain_id
    if v in (0, 1):
        return v, None
    raise ValueError(f"invalid v {v}")
