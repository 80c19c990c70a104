"""The work functions' permutation counts for both cells' shapes, against
the counts the shapes give by hand."""

from zkbench import harness, traffic, work
from zkbench.reference import recursion


def test_permutation_cost():
    # 8 full rounds x 12 S-boxes + 22 partial x 1; 4 products an S-box, 12
    # by the internal diagonal a partial round; 2 of each S-box's squarings
    assert work.GL_MULS_PER_PERM + work.GL_SQRS_PER_PERM == 736
    assert work.GL_SQRS_PER_PERM == 236
    assert work.MADS_PER_PERM == 500 * 4 + 236 * 3 == 2708


def test_chunk_cell_permutations():
    # one chunk: m = 4,096 x 4 = 16,384 leaves of [A, D], one permutation a
    # leaf and 16,383 compressions; FRI from 16,384 points to 64, eight
    # layers of s / 2 leaves and s / 2 - 1 compressions
    m = 16384
    fri = sum(s - 1 for s in (16384, 8192, 4096, 2048, 1024, 512, 256, 128))
    assert fri == 32632
    per_chunk = (m + m - 1) + fri
    assert per_chunk == 65399
    # the cell's payload: 365,387 bytes, 52,199 elements, 12 chunks of 4,094
    # and one of 3,071, each proved on the full 4,096 rows
    cell = harness.load_cell("chunks.stark-wrap-2leaf.block-30m")
    assert traffic.chunk_count(cell["traffic"], cell["config"]) == 13
    assert work.chunk_batch(13, 4096, 4, 64).perms == 13 * 65399 == 850_187


def test_aggregate_cell_permutations():
    air, _, _, _ = recursion.attestation_air(4096, 32, 64)
    assert (air.n, air.n_cols, air.ext_blowup) == (1 << 18, 216, 8)
    m = 1 << 21
    leaves = m * 27  # 216 elements at rate 8
    tree = m - 1
    fri = sum((1 << k) - 1 for k in range(7, 22))  # 2^21 down to 128, terminal 64
    assert fri == (1 << 22) - (1 << 7) - 15
    per_att = leaves + tree + fri
    assert per_att == 62_914_416
    assert work.attestation(air.n, air.n_cols, air.ext_blowup).perms == per_att


def test_bytes_and_bound():
    w = work.commit(4, 9)  # 4 rows of 9: 2 permutations a row, 3 compressions
    assert w.perms == 4 * 2 + 3
    assert w.nbytes == 4 * 9 * 8 + 4 * 32 + 4 * 32 + 3 * 32
    secs, by = work.least_seconds(work.Work(perms=10**6, nbytes=10**6))
    assert by == "operations" and secs == 10**6 * 2708 / 16.75e12
    secs, by = work.least_seconds(work.Work(perms=1, nbytes=10**9))
    assert by == "bytes" and secs == 10**9 / 3.35e12
