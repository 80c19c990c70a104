"""The work of the wrap profile's attestation in kernel F's permutations,
worked out from its shape, and the least time the card could take for it.

Kernel F is the Poseidon2 permutation over BN254 Fr (t = 12, rate 11, x^5,
8 full and 68 partial rounds).  A row of k Goldilocks values is packed three
to an Fr element and hashed by the rate-11 sponge in max(1, ceil(ceil(k / 3)
/ 11)) permutations; a Merkle tree over N leaves takes N - 1 two-to-one
compressions of one permutation each.  An attestation commits the trace's
LDE rows (the trace tree), then FRI's layers: the first layer's tree is the
composition's commitment, a layer of s points commits s / 2 leaves of two
values (one Fr element, one permutation).  The constants tree is committed
once a process, in set-up, and the grinding's candidates are a search, not
a commitment: neither is counted.  The count follows the prover's
commitments, not the launches that make them, so it reads the same whatever
implements the hashing.

A permutation is 151,568 32-bit multiply-adds.  Its products: 8 full
rounds x 12 S-boxes and 68 partial rounds x 1, each S-box x^5 two Montgomery
squarings and one product, and 68 x 12 products by the internal diagonal,
so 980 products and 328 squarings.  A Montgomery product of 254-bit values
on 32-bit limbs is 136 multiply-adds (64 for the product, 72 for the
reduction), a squaring 108 (the cross products once).  The 816 products by
the diagonal are by constants below r, which Shoup's product does in 115
(43 for the quotient, 36 each for the low halves of x·mu and q·r); the other
164 products are Montgomery products: 164 x 136 + 816 x 115 + 328 x 108 =
151,568.  The conversions into and out of Montgomery form and the linear
layers' additions are not counted.  The peaks are `work.py`'s.
"""

from __future__ import annotations

from .work import HBM_BYTES_PER_S, INT32_MADS_PER_S, Work

RATE_FR = 11
GL_PACK = 3
FR_BYTES = 32  # an Fr digest on the card: four 64-bit words
GL_BYTES = 8
MADS_PER_MONT_MUL, MADS_PER_MONT_SQR, MADS_PER_CONST_MUL = 136, 108, 43 + 2 * 36
FR_MULS_PER_PERM = 8 * 12 + 68 * (1 + 12)
FR_SQRS_PER_PERM = 2 * (8 * 12 + 68)
FR_CONST_MULS_PER_PERM = 68 * 12
MADS_PER_PERM_FR = ((FR_MULS_PER_PERM - FR_CONST_MULS_PER_PERM) * MADS_PER_MONT_MUL
                    + FR_CONST_MULS_PER_PERM * MADS_PER_CONST_MUL
                    + FR_SQRS_PER_PERM * MADS_PER_MONT_SQR)


def perms_per_row(k: int) -> int:
    """Sponge permutations over a row of k Goldilocks values."""
    return max(1, -(-(-(-k // GL_PACK)) // RATE_FR))


def commit(rows: int, width: int) -> Work:
    """One Fr Merkle commitment over `rows` leaves of `width` Goldilocks
    values: the leaf sponge (rows read, digests written) and the tree
    (digests read, every level above them written)."""
    assert rows >= 1 and rows & (rows - 1) == 0
    leaves = Work(rows * perms_per_row(width), rows * width * GL_BYTES + rows * FR_BYTES)
    tree = Work(rows - 1, rows * FR_BYTES + (rows - 1) * FR_BYTES)
    return leaves + tree


def wrap_attestation(n: int, n_cols: int, blowup: int, terminal: int = 64) -> Work:
    """One wrap-profile attestation: the trace tree over m = n·blowup rows
    of n_cols values, then FRI's layers down to `terminal` points."""
    m = n * blowup
    w, s = commit(m, n_cols), m
    while s > terminal:
        w = w + commit(s // 2, 2)
        s //= 2
    return w


def least_seconds(w: Work) -> tuple[float, str]:
    """The card's least time for F's work: the larger of its multiply-adds
    over the integer rate and its bytes over the memory rate, and which."""
    by_ops = w.perms * MADS_PER_PERM_FR / INT32_MADS_PER_S
    by_bytes = w.nbytes / HBM_BYTES_PER_S
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
