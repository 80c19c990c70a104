"""The port's Poseidon2, Merkle tree, transcript and FRI fold against the
JAX package.

Poseidon is held against the JAX package's numpy permutation (`np_perm`)
and its python-int sponges; Merkle trees against `merkle.commit_leaves` on
the CPU (wide and ragged rows included, as the AIR prover commits them);
the fold against `fri.fold_layer` run eagerly and the single-polynomial
prover against `fri.fri_prove`.  Inputs come from numpy with a fixed seed.  Tolerance: none — exact integer equality.
"""

import numpy as np
import pytest
import torch

from eigen_zeth_tpu.models import fri as jfri
from eigen_zeth_tpu.models import merkle as jmerkle
from eigen_zeth_tpu.models import transcript as jtranscript
from eigen_zeth_tpu.ops import goldilocks as jgl
from eigen_zeth_tpu.ops import poseidon as jps
from eigen_zeth_tpu_torch.models import fri, merkle, transcript
from eigen_zeth_tpu_torch.ops import goldilocks as gl
from eigen_zeth_tpu_torch.ops import poseidon as ps

P = gl.P
RNG_SEED = 0x9053


def _rand(shape, seed):
    return np.random.default_rng(RNG_SEED + seed).integers(0, P, shape, dtype=np.uint64)


def test_constants_are_the_jax_ones():
    assert ps.round_constants() == jps.round_constants()
    assert ps.internal_diag() == jps.internal_diag()
    assert ps.external_matrix() == jps.external_matrix()
    mod = ps.Poseidon2()
    assert (mod.rc.numpy().view(np.uint64) == np.asarray(jps.round_constants(), np.uint64)).all()
    assert (mod.diag.numpy().view(np.uint64) == np.asarray(jps.internal_diag(), np.uint64)).all()


def test_perm_matches_numpy_reference():
    states = _rand((64, 12), 1)
    states[0] = 0
    states[1] = P - 1
    got = gl.to_int(ps.perm(gl.from_int(states, "cpu")))
    assert (got == jps.np_perm(states)).all()
    assert [int(v) for v in got[2]] == jps.perm_host([int(v) for v in states[2]])


def test_perm_keeps_batch_shape():
    states = _rand((2, 3, 12), 2)
    got = gl.to_int(ps.perm(gl.from_int(states, "cpu")))
    assert got.shape == (2, 3, 12)
    assert (got.reshape(6, 12) == jps.np_perm(states.reshape(6, 12))).all()


@pytest.mark.parametrize("k", [0, 1, 5, 8, 9, 17])
def test_hash_elements_matches_host(k):
    rows = _rand((4, k), 3 + k)
    got = gl.to_int(ps.hash_elements(gl.from_int(rows, "cpu")))
    for r in range(4):
        assert [int(v) for v in got[r]] == jps.hash_elements_host([int(v) for v in rows[r]])


def test_hash_two_matches_host():
    left, right = _rand((8, 4), 4), _rand((8, 4), 5)
    got = gl.to_int(ps.hash_two(gl.from_int(left, "cpu"), gl.from_int(right, "cpu")))
    for r in range(8):
        want = jps.hash_two_host([int(v) for v in left[r]], [int(v) for v in right[r]])
        assert [int(v) for v in got[r]] == want


def test_host_copies_are_the_jax_ones():
    s = [int(v) for v in _rand(12, 6)]
    assert ps.perm_host(s) == jps.perm_host(s)
    assert ps.hash_elements_host(s[:7]) == jps.hash_elements_host(s[:7])
    t, jt = transcript.Transcript("t"), jtranscript.Transcript("t")
    for tr in (t, jt):
        tr.absorb("x", s)
    assert t.challenges("c", 11) == jt.challenges("c", 11)
    assert t.challenge_indices("q", 5, 64) == jt.challenge_indices("q", 5, 64)


@pytest.mark.parametrize("n,k", [(32, 2), (16, 3), (1, 2)])
def test_merkle_root_and_paths_match_jax(n, k):
    leaves = _rand((n, k), 7 + n)
    tree = merkle.MerkleTree(merkle.commit_leaves(gl.from_int(leaves, "cpu")))
    ref = jmerkle.commit_leaves(jgl.from_int(leaves), prefer_host=True)
    assert tree.root() == ref.root()
    idx = list(range(n)) if n <= 4 else [0, 3, n - 1, n // 2]
    assert tree.open_many(idx) == ref.open_many(idx)
    for i in idx:
        assert jmerkle.verify_path(tree.root(), i, [int(v) for v in leaves[i]], tree.open(i))
        assert merkle.verify_path(tree.root(), i, [int(v) for v in leaves[i]], tree.open(i))


def test_batched_trees_open_like_single_trees():
    leaves = _rand((3, 16, 2), 8)
    levels = merkle.commit_leaves(gl.from_int(leaves, "cpu"))
    idx = torch.tensor([[1, 5], [0, 15], [7, 7]])
    paths = merkle.open_batched(levels, idx)
    roots = merkle.roots(levels)
    for k in range(3):
        ref = jmerkle.commit_leaves(jgl.from_int(leaves[k]), prefer_host=True)
        assert [int(v) for v in roots[k]] == ref.root()
        want = ref.open_many(idx[k].tolist())
        assert [[[int(v) for v in d] for d in p] for p in paths[k]] == want


@pytest.mark.parametrize("m,shift", [(64, 7), (16, 49)])
def test_fold_layer_matches_jax(m, shift):
    ev = _rand(m, 9 + m)
    beta = int(_rand(1, 10)[0])
    got = gl.to_int(fri.fold_layer(gl.from_int(ev, "cpu"), beta, shift))
    assert (got == jgl.to_int(jfri.fold_layer(jgl.from_int(ev), beta, shift))).all()


def test_batched_fold_uses_one_beta_per_row():
    ev = _rand((2, 32), 11)
    betas = [int(v) for v in _rand(2, 12)]
    got = gl.to_int(fri.fold_layer(gl.from_int(ev, "cpu"), gl.from_int(betas, "cpu")[:, None], 7))
    for r in range(2):
        assert (got[r] == jgl.to_int(jfri.fold_layer(jgl.from_int(ev[r]), betas[r], 7))).all()


def test_fri_params_schedule_is_the_jax_one():
    for m in (16, 256, 4096):
        for arity in (2, 8):
            a = fri.FriParams(terminal_size=16, arity=arity)
            b = jfri.FriParams(terminal_size=16, arity=arity)
            assert a.layer_schedule(m) == b.layer_schedule(m)


@pytest.mark.parametrize("k", [0, 1, 9, 13, 216])
def test_hash_elements_on_wide_and_ragged_rows(k):
    """Rows of the AIR prover's kinds: empty, shorter than the rate, one past
    it, not a multiple of 8, and the attestation trace's 216 columns; as a
    row-major tensor and as the transpose of a column matrix."""
    rows = _rand((6, k), 20 + k)
    rows[0], rows[1] = 0, P - 1
    want = jps.np_hash_elements(rows)
    got = gl.to_int(ps.hash_elements(gl.from_int(rows, "cpu")))
    assert got.shape == (6, 4) and (got == want).all()
    cols = gl.from_int(np.ascontiguousarray(rows.T), "cpu")
    assert (gl.to_int(ps.hash_elements(cols.T)) == want).all()
    assert (gl.to_int(ps.hash_elements_plain(cols.T)) == want).all()
    for r in (0, 1, 5):
        assert [int(v) for v in got[r]] == ps.hash_elements_host([int(v) for v in rows[r]])


def test_internal_matrix_is_the_jax_one():
    assert ps.internal_matrix() == jps.internal_matrix()


@pytest.mark.parametrize("n,k", [(64, 13), (8, 216), (2, 9)])
def test_commit_tree_over_wide_rows_matches_jax(n, k):
    leaves = _rand((n, k), 30 + k)
    cols = gl.from_int(np.ascontiguousarray(leaves.T), "cpu")
    tree = merkle.commit_tree(cols.T)  # the AIR prover's call: rows of a column matrix
    ref = jmerkle.commit_leaves(jgl.from_int(leaves), prefer_host=True)
    assert isinstance(tree, merkle.MerkleTree) and tree.root() == ref.root()
    idx = [0, n - 1, n // 2]
    assert tree.open_many(idx) == ref.open_many(idx)
    for i in idx:
        assert merkle.verify_path(tree.root(), i, [int(v) for v in leaves[i]], tree.open(i))


@pytest.mark.parametrize("m,terminal,blowup", [(512, 64, 4), (64, 64, 4), (256, 16, 2)])
def test_fri_prove_matches_jax(m, terminal, blowup):
    """The single-polynomial prover (the AIR path): the same proof dict as
    the JAX package's host-orchestrated `fri_prove`, accepted by both
    verifiers; a polynomial of too high a degree is refused."""
    deg = m // blowup
    coeffs = np.zeros(m, dtype=np.uint64)
    coeffs[:deg] = _rand(deg, 40 + m)
    evals = gl.np_ntt(gl.np_mulmod(coeffs, gl.powers_np(7, m)))  # on the coset 7·H
    a = fri.FriParams(blowup=blowup, num_queries=5, terminal_size=terminal)
    b = jfri.FriParams(blowup=blowup, num_queries=5, terminal_size=terminal)
    t, jt = transcript.Transcript("fri-test"), jtranscript.Transcript("fri-test")
    got = fri.fri_prove(gl.from_int(evals, "cpu"), 7, t, a)
    want = jfri.fri_prove(jgl.from_int(evals), 7, jt, b, fused=False)
    assert got.proof == want.proof and got.layer0_indices == want.layer0_indices
    assert t.challenge("after") == jt.challenge("after")
    assert fri.fri_verify(want.proof, transcript.Transcript("fri-test"), a)[0]
    assert jfri.fri_verify(got.proof, jtranscript.Transcript("fri-test"), b)[0]
    coeffs[deg] = 1
    bad = gl.np_ntt(gl.np_mulmod(coeffs, gl.powers_np(7, m)))
    with pytest.raises(AssertionError, match="terminal degree"):
        fri.fri_prove(gl.from_int(bad, "cpu"), 7, transcript.Transcript("fri-test"), a)


def test_fri_params_grind_bits_default_and_refusal():
    assert fri.FriParams().grind_bits == jfri.FriParams().grind_bits == 0
    ev = gl.from_int(np.zeros(128, dtype=np.uint64), "cpu")
    with pytest.raises(AssertionError, match="grind"):
        fri.fri_prove(ev, 7, transcript.Transcript("g"), fri.FriParams(grind_bits=4))
