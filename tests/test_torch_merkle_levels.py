"""Kernel E's tree entry and its lazy Poseidon2 schedule, on the CPU.

`poseidon.merkle_levels_plain` (the tree entry's plain version) and
`merkle.commit_digests` on batched and 2-D levels against the JAX package's
trees: its `models/merkle.py` host commit, the loop of its `commit_digests`
over its numpy Poseidon2 (its device `commit_digests` compiles the
permutation for XLA on the CPU at every level's shape, which takes longer
than this file may); and a python-int model of the order of
accumulations and reductions in csrc/poseidon2_gl.cuh, on the constants as
ops/kernels.py lays them out, which asserts every bound that
csrc/goldilocks.cuh and csrc/poseidon2_gl.cuh state and must equal
`perm_host` and the host sponge.  Inputs come from numpy with a fixed seed.
Tolerance: none — exact integer equality.
"""

import numpy as np
import pytest

from eigen_zeth_tpu.models import merkle as jmerkle
from eigen_zeth_tpu.ops import goldilocks as jgl
from eigen_zeth_tpu_torch.models import merkle
from eigen_zeth_tpu_torch.ops import goldilocks as gl
from eigen_zeth_tpu_torch.ops import kernels
from eigen_zeth_tpu_torch.ops import poseidon as ps

P = gl.P
EPS = (1 << 32) - 1
W64, W96, W128 = 1 << 64, 1 << 96, 1 << 128
EDGE = [0, 1, P - 1, P - (1 << 32), (1 << 32) - 1, 1 << 32]


def _rand(shape, seed):
    return np.random.default_rng(0x7E5 + seed).integers(0, P, shape, dtype=np.uint64)


# ---------------------------------------------------------------------------
# the tree entry's plain version and the split schedule against the JAX package


@pytest.mark.parametrize("trees", [1, 3])
@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_levels_match_jax_trees(n, trees):
    rows = _rand((trees, n, 2), n + trees)  # FRI's pairs
    want = [[jgl.to_int(lv) for lv in jmerkle.commit_leaves(jgl.from_int(rows[k]),
                                                             prefer_host=True).levels]
            for k in range(trees)]
    x = ps.hash_elements(gl.from_int(rows, "cpu"))
    depth = n.bit_length() - 1
    for levels in (merkle.commit_digests(x), [x] + ps.merkle_levels(x)):
        assert len(levels) == depth + 1
        for j, level in enumerate(levels):
            assert level.shape == (trees, n >> j, 4)
            for k in range(trees):
                assert (gl.to_int(level[k]) == want[k][j]).all()
    above = ps.merkle_levels_plain(x[0])  # a 2-D level
    assert [tuple(t.shape) for t in above] == [(n >> j, 4) for j in range(1, depth + 1)]
    assert all((gl.to_int(t) == want[0][j]).all() for j, t in enumerate(above, 1))


def test_plain_levels_read_strided_digests():
    digests = _rand((2, 32, 4), 5)
    x = gl.from_int(digests, "cpu")
    got = ps.merkle_levels_plain(x[:, 0::2])  # every other digest, as a level lies
    ref = ps.merkle_levels_plain(x[:, 0::2].contiguous())
    assert len(got) == 4 and got[-1].shape == (2, 1, 4)
    assert all((gl.to_int(a) == gl.to_int(b)).all() for a, b in zip(got, ref))
    node = ps.hash_two_host([int(v) for v in digests[1, 0]], [int(v) for v in digests[1, 2]])
    assert [int(v) for v in gl.to_int(got[0][1, 0])] == node
    with pytest.raises(AssertionError):
        ps.merkle_levels_plain(x[:, :24])  # not a power of two


# ---------------------------------------------------------------------------
# a python-int model of the kernel's lazy schedule


def _word(x):
    assert 0 <= x < W64, "a word is below 2^64"
    return x


def _canonical(x):
    assert 0 <= x < P, "this operand must be canonical"
    return x


def reduce128(x):
    """goldilocks.cuh `reduce(Acc128)`, word by word."""
    assert 0 <= x < W128
    x0, x1, x2, x3 = ((x >> (32 * i)) & EPS for i in range(4))
    c = (x1 + x2) >> 32
    h = (x1 + x2 + c) & EPS
    assert c == 0 or (x1 + x2) - (1 << 32) <= (1 << 32) - 2  # h + c cannot wrap
    d = x2 + x3 + c
    assert d < 1 << 33
    r = ((h << 32) | x0) - d
    if r < 0:  # a borrow: r + 2^64 >= 2^64 - 2^33 + 1, then + p mod 2^64
        r += W64
        assert r >= W64 - (1 << 33) + 1
        r = (r + P) % W64
    assert r % P == x % P
    return _word(r)


def reduce96(x):
    """goldilocks.cuh `reduce(Acc96)`."""
    assert 0 <= x < W96
    s = (x % W64) + (x >> 64) * EPS
    assert s < 2 * W64
    if s >= W64:
        s -= W64
        assert s <= W64 - (1 << 33)
        s += EPS
    assert s % P == x % P
    return _word(s)


def mul_add(a, b, c=0):
    """goldilocks.cuh `mul_add`: a·b + c below 2^128 for a canonical b."""
    _word(a)
    _canonical(b)
    assert 0 <= c < W96
    assert a * b <= W128 - W96 - W64 + (1 << 32)
    v = a * b + c
    assert v < W128
    return v


def lazy_add(a, b):
    """goldilocks.cuh `add`: a word plus a canonical element."""
    s = _word(a) + _canonical(b)
    if s >= W64:
        s -= W64
        assert s < P - 1
        s += EPS
    return _word(s)


def m4(x):
    """poseidon2_gl.cuh `m4`: outputs below 16·2^64."""
    top = max(x)
    t0, t1 = x[0] + x[1], x[2] + x[3]
    t2, t3 = 2 * x[1] + t1, 2 * x[3] + t0
    t4, t5 = 4 * t1 + t3, 4 * t0 + t2
    y = [t3 + t5, t5, t2 + t4, t4]
    assert all(v <= 16 * top and v < 16 * W64 for v in y)
    return y


def external(s, add):
    """poseidon2_gl.cuh `external`: each output one sum below 2^71, reduced once."""
    z = [m4(s[4 * b: 4 * b + 4]) for b in range(3)]
    out = [0] * 12
    for i in range(4):
        tot = z[0][i] + z[1][i] + z[2][i]
        assert tot < 48 * W64
        for b in range(3):
            v = z[b][i] + tot + _canonical(add[4 * b + i])
            assert v < 65 * W64 < 1 << 71
            out[4 * b + i] = reduce96(v)
    return out


def mul(a, b):
    """goldilocks.cuh `mul` and `sqr`: any two words, below 2^128."""
    return _word(a) * _word(b)


def sbox(x):
    x2 = reduce128(mul(x, x))
    x4 = reduce128(mul(x2, x2))
    x3 = reduce128(mul(x2, x))
    return reduce128(mul(x4, x3))


def partial_round(s, next_add, diag):
    s = list(s)
    s[0] = sbox(s[0])
    tot = sum(s)
    assert tot < 12 * W64
    return [reduce128(mul_add(s[i], diag[i], tot + _canonical(next_add[i]))) for i in range(12)]


def lazy_perm(state, words=None):
    """The kernel's permutation, step for step, on its constant layout."""
    w = words or kernels.poseidon2_const_words()
    assert len(w) == 153
    first, full_next = w[:12], [w[12 + 12 * r: 24 + 12 * r] for r in range(8)]
    partial_next, partial_last, diag = w[108:129], w[129:141], w[141:153]
    s = external([_word(v) for v in state], first)
    for r in range(8):
        s = external([sbox(v) for v in s], full_next[r])
        if r == 3:
            for j in range(21):
                s = partial_round(s, [partial_next[j]] + [0] * 11, diag)
            s = partial_round(s, partial_last, diag)
    return s


def lazy_hash(elements):
    """`hash_rows`' sponge: blocks added lazily, only the digest canonical."""
    s = [0] * 12
    s[8] = len(elements)
    for i in range(0, max(len(elements), 1), 8):
        for j, v in enumerate(elements[i: i + 8]):
            s[j] = lazy_add(s[j], v)
        s = lazy_perm(s)
    return [v % P for v in s[:4]]


def test_lazy_schedule_equals_perm_host():
    rng = np.random.default_rng(0x1A2)
    states = [[v] * 12 for v in EDGE]
    states += [[int(v) for v in rng.choice(np.asarray(EDGE, dtype=np.uint64), 12)]
               for _ in range(20)]
    states += [[int(v) for v in row] for row in _rand((100, 12), 9)]
    words = kernels.poseidon2_const_words()
    for state in states:
        assert [v % P for v in lazy_perm(state, words)] == ps.perm_host(state)


def test_lazy_sponge_equals_host_sponge_and_compression():
    rows = _rand((6, 20), 11)
    rows[0] = P - 1
    for k in (0, 1, 8, 9, 20):
        for row in rows[:3]:
            elements = [int(v) for v in row[:k]]
            assert lazy_hash(elements) == ps.hash_elements_host(elements)
    left, right = [int(v) for v in rows[3, :4]], [int(v) for v in rows[4, :4]]
    assert [v % P for v in lazy_perm(left + right + [0] * 4)[:4]] == ps.hash_two_host(left, right)


def test_lazy_bounds_hold_at_their_extremes():
    """Each step on the largest words it can be given: every bound holds and
    the result is congruent to the canonical computation."""
    top = W64 - 1
    assert reduce128(W128 - 1) % P == (W128 - 1) % P
    assert reduce96(W96 - 1) % P == (W96 - 1) % P
    assert reduce128(0) == 0 and reduce96(0) == 0
    diag = ps.internal_diag()
    words = kernels.poseidon2_const_words()
    out = partial_round([top] * 12, words[129:141], diag)  # every mu_i·s_i at its largest
    s0 = pow(top % P, 7, P)
    tot = (s0 + 11 * top) % P
    want = [(tot + diag[i] * (s0 if i == 0 else top) + words[129 + i]) % P for i in range(12)]
    assert [v % P for v in out] == want
    ext = external([top] * 12, [P - 1] * 12)  # M4's row sums 16, 12, 16, 12; x 4 in M_E
    assert [v % P for v in ext] == [(4 * (16, 12)[i % 2] * top + P - 1) % P for i in range(12)]
    assert sbox(top) % P == pow(top % P, 7, P)
    assert lazy_add(top, P - 1) % P == (top + P - 1) % P
    for v in (0, 1, P - 1, P, top):
        assert (v - P if v >= P else v) == v % P  # canon: one subtraction suffices
