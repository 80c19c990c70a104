"""The benchmark's plain Poseidon2-Fr, Fr transcript and Fr Merkle trees
(zkbench/reference/) against the port's host forms, which the port's tests
hold to the JAX package: the permutation on seeded states and at the edges
(0, 1, r - 1), on host ints and batched on int64 limbs; the sponge at
lengths around the rate, both forms; the 2-to-1 compression; the packing of
Goldilocks values; the transcript's absorbs, challenges, query indices and
grinding check; Merkle paths of a tree the port commits, and each tampered
claim refused; the constants root of an AIR's periodic columns, both forms,
against the port's."""

import random

import numpy as np
import pytest
import torch

from eigen_zeth_tpu_torch.models import air as program_air
from eigen_zeth_tpu_torch.models import air_wrap as program_air_wrap
from eigen_zeth_tpu_torch.models import merkle_fr as program_merkle_fr
from eigen_zeth_tpu_torch.models import transcript_fr as program_transcript_fr
from eigen_zeth_tpu_torch.ops import goldilocks as program_gl
from eigen_zeth_tpu_torch.ops import poseidon_fr as program_pfr
from zkbench.reference import air, air_wrap, merkle_fr, poseidon_fr, transcript_fr

CPU = torch.device("cpu")
R = poseidon_fr.R
P = 0xFFFFFFFF00000001


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(seed, n):
    rng = random.Random(seed)
    return [[rng.randrange(R) for _ in range(12)] for _ in range(n)]


EDGES = [[0] * 12, [1] * 12, [R - 1] * 12, [R - 1, 0, 1] * 4]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_permutation_equals_the_port(seed):
    states = _states(seed, 6) + EDGES
    want = [program_pfr.perm_host(s) for s in states]
    assert [poseidon_fr.perm_host(s) for s in states] == want
    got = poseidon_fr.perm(poseidon_fr.from_ints(states, CPU))
    assert poseidon_fr.to_ints(got) == [v for s in want for v in s]


@pytest.mark.parametrize("length", [1, 10, 11, 12, 22, 41, 72])
def test_sponge_equals_the_port(length):
    rng = random.Random(length)
    rows = [[rng.randrange(R) for _ in range(length)] for _ in range(3)] + [[R - 1] * length]
    want = [program_pfr.hash_elements_host(r) for r in rows]
    assert [poseidon_fr.hash_elements_host(r) for r in rows] == want
    assert poseidon_fr.to_ints(poseidon_fr.hash_rows(poseidon_fr.from_ints(rows, CPU))) == want


def test_rows_of_different_lengths_hash_at_once():
    rng = random.Random(5)
    rows = [[rng.randrange(R) for _ in range(n)] for n in (41, 18, 1, 11, 12)]
    k = max(len(r) for r in rows)
    padded = poseidon_fr.from_ints([r + [0] * (k - len(r)) for r in rows], CPU)
    got = poseidon_fr.hash_rows(padded, [len(r) for r in rows])
    assert poseidon_fr.to_ints(got) == [program_pfr.hash_elements_host(r) for r in rows]


def test_compression_and_packing_equal_the_port():
    pairs = [(3, 9), (R - 1, 0), (123456789, R - 2)]
    want = [program_pfr.hash_two_host(a, b) for a, b in pairs]
    assert [poseidon_fr.hash_two_host(a, b) for a, b in pairs] == want
    left = poseidon_fr.from_ints([a for a, _ in pairs], CPU)
    right = poseidon_fr.from_ints([b for _, b in pairs], CPU)
    assert poseidon_fr.to_ints(poseidon_fr.compress(left, right)) == want
    rng = random.Random(9)
    vals = [rng.randrange(P) for _ in range(10)] + [P - 1, 0, 2**63]
    assert poseidon_fr.pack_gl(vals) == program_pfr.pack_gl_host(vals)
    t = torch.from_numpy(np.array(vals, dtype=np.uint64).view(np.int64))
    assert poseidon_fr.to_ints(poseidon_fr.pack_gl_limbs(t)) == program_pfr.pack_gl_host(vals)


def test_transcript_equals_the_port():
    ours = transcript_fr.TranscriptFr("ezt-test")
    theirs = program_transcript_fr.TranscriptFr("ezt-test")
    for t in (ours, theirs):
        t.absorb("public", list(range(15)))
        t.absorb_packed_gl("fri-final", [P - 1, 5, 7, 2**40])
    assert ours.challenge_gl("alpha") == theirs.challenge_gl("alpha")
    assert ours.challenge_fr("x") == theirs.challenge_fr("x")
    assert ours.challenge_indices("q", 5, 1 << 20) == theirs.challenge_indices("q", 5, 1 << 20)
    before = _copy(ours)
    nonce = theirs.grind(6, device=CPU)  # the least nonce that passes
    assert ours.grind_check(nonce, 6)
    assert ours.challenge_fr("after") == theirs.challenge_fr("after")
    assert nonce > 0 and not any(_copy(before).grind_check(n, 6) for n in range(nonce))


def _copy(t):
    c = transcript_fr.TranscriptFr("ezt-test")
    c._state, c._pos = list(t._state), t._pos
    return c


def test_merkle_paths_of_the_port_tree():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, P, size=(16, 7), dtype=np.uint64)
    tree = program_merkle_fr.commit_rows_gl(program_gl.from_int(rows, CPU))
    root = tree.root()
    idx = [0, 5, 15]
    paths = tree.open_many(idx)
    good = [merkle_fr.PathCheck(root, i, poseidon_fr.pack_gl(rows[i].tolist()), p)
            for i, p in zip(idx, paths)]
    assert merkle_fr.verify_paths(good, CPU) == [True] * 3
    bad = [merkle_fr.PathCheck(root, 6, good[1].elements, paths[1]),
           merkle_fr.PathCheck(root, 5, good[1].elements, paths[1][:2] + [paths[1][2] + 1]
                               + paths[1][3:]),
           merkle_fr.PathCheck(root, 5, [good[1].elements[0] + 1] + good[1].elements[1:],
                               paths[1]),
           merkle_fr.PathCheck(root + 1, 5, good[1].elements, paths[1])]
    assert merkle_fr.verify_paths(bad + good[:1], CPU) == [False] * 4 + [True]
    assert merkle_fr.commit_root(program_gl.from_int(rows, CPU), block=4) == root
    assert merkle_fr.commit_root_host(rows.tolist()) == root


def test_constants_root_equals_the_port():
    pats = [np.array([1, 0, 0, 0], dtype=np.uint64),
            np.array([5, 7, P - 1, 3, 9, 11, 13, 2**63], dtype=np.uint64),
            np.array([2] * 16, dtype=np.uint64)]
    ours = air.Air(n=16, n_cols=2, periodic=pats, constraints=[], name="toy", ext_blowup=8)
    theirs = program_air.Air(n=16, n_cols=2, periodic=pats, constraints=[], name="toy",
                             ext_blowup=8)
    want = program_air_wrap.constants_root(theirs, 7, CPU)
    assert air_wrap.constants_root(ours, CPU) == want == air_wrap.constants_root_host(ours)
