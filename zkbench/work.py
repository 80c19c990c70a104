"""The work the cells' requests need, worked out from their shapes, and the
least time the card could take for it.

Kernel E is the Poseidon2-Goldilocks permutation (t = 12, 8 full and 22
partial rounds).  Its work is counted in permutations: a row of k elements
is hashed by the rate-8 sponge in max(1, ceil(k / 8)) permutations, and a
Merkle tree over N leaves takes N - 1 two-to-one compressions of one
permutation each.  The count follows the provers' commitments, not the
launches that make them, so it reads the same whatever implements the
hashing.

The peaks (NVIDIA H100 SXM data sheet; a card below its 700 W limit is
slower, so every reading carries the card's `power.limit`):
  * device memory: 3.35 TB/s;
  * 32-bit integer multiply-adds: 16.75 T/s.  The data sheet gives 67
    TFLOP/s float32, two operations per fused multiply-add on 128 float32
    lanes of each of 132 SMs at 1.98 GHz (132 x 128 x 2 x 1.98e9 = 66.9e12);
    the integer pipe has 64 lanes an SM and one multiply-add each, a quarter
    of that figure (132 x 64 x 1.98e9 = 16.7e12).  No data sheet states the
    integer rate itself: it is an assumed peak.
A permutation is 2,708 wide 32-bit multiply-adds: a Goldilocks product is
four 32 x 32 -> 64 multiply-adds (the fold is shifts, adds and compares), a
squaring three; each of the 118 S-boxes (x^7 = x^4 * x^3) squares twice,
8 x 12 x 4 + 22 x (4 + 12) = 736 products in all, 236 of them squarings.
"""

from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12
INT32_MADS_PER_S = 67e12 / 4

WIDTH, RATE, DIGEST = 12, 8, 4
MADS_PER_GL_MUL, MADS_PER_GL_SQR = 4, 3
GL_SQRS_PER_PERM = 2 * (8 * 12 + 22)
GL_MULS_PER_PERM = 8 * 12 * 4 + 22 * (4 + 12) - GL_SQRS_PER_PERM
MADS_PER_PERM = GL_MULS_PER_PERM * MADS_PER_GL_MUL + GL_SQRS_PER_PERM * MADS_PER_GL_SQR
WORD = 8  # bytes of a Goldilocks element


@dataclass(frozen=True)
class Work:
    """Permutations, and bytes read once and written once."""

    perms: int = 0
    nbytes: int = 0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.perms + other.perms, self.nbytes + other.nbytes)

    def __mul__(self, k: int) -> "Work":
        return Work(self.perms * k, self.nbytes * k)


def perms_per_row(k: int) -> int:
    return max(1, -(-k // RATE))


def commit(rows: int, width: int) -> Work:
    """One Merkle commitment over `rows` leaves of `width` elements: the
    leaf sponge (rows read, digests written) and the tree (digests read,
    every level above them written)."""
    assert rows >= 1 and rows & (rows - 1) == 0
    leaves = Work(rows * perms_per_row(width), rows * width * WORD + rows * DIGEST * WORD)
    tree = Work(rows - 1, rows * DIGEST * WORD + (rows - 1) * DIGEST * WORD)
    return leaves + tree


def fri_commits(m: int, terminal: int) -> Work:
    """FRI's layer commitments over an m-point domain down to `terminal`
    points at arity 2: a layer of s points commits s / 2 leaves of 2."""
    w, s = Work(), m
    while s > terminal:
        w = w + commit(s // 2, 2)
        s //= 2
    return w


def chunk_stark(rows: int, blowup: int, terminal: int) -> Work:
    """One chunk proof: the trace tree over m = rows * blowup leaves of
    [A, D], then FRI on the composition."""
    m = rows * blowup
    return commit(m, 2) + fri_commits(m, terminal)


def chunk_batch(chunks: int, rows: int, blowup: int, terminal: int) -> Work:
    """Step 2 on `chunks` chunks."""
    return chunk_stark(rows, blowup, terminal) * chunks


def attestation(n: int, n_cols: int, ext_blowup: int, terminal: int = 64) -> Work:
    """One verifier-AIR attestation: the trace tree over m = n * ext_blowup
    rows of n_cols elements, then FRI on the composition (terminal 64)."""
    m = n * ext_blowup
    return commit(m, n_cols) + fri_commits(m, terminal)


def least_seconds(w: Work) -> tuple[float, str]:
    """The card's least time for the work: the larger of its multiply-adds
    over the integer rate and its bytes over the memory rate, and which."""
    by_ops = w.perms * MADS_PER_PERM / INT32_MADS_PER_S
    by_bytes = w.nbytes / HBM_BYTES_PER_S
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
