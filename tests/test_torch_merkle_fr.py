"""The port's Poseidon2-Fr Merkle tree against the JAX package's.

(n, 216) rows of canonical Goldilocks values made from a numpy seed (the
width of the verifier AIR's trace), n from 64 to 1,024, are committed by
the JAX package's `commit_rows_gl` (its native host engine) and by the
port's on CPU tensors (host batches), and by kernel F's plain versions;
every level, the root and the openings must be equal.  The port's
`verify_path_*` accept those openings and reject tampered ones.
Tolerance: none.
"""

import numpy as np
import pytest
import torch

from eigen_zeth_tpu.models import merkle_fr as jmfr
from eigen_zeth_tpu.ops import goldilocks as jgl
from eigen_zeth_tpu_torch.models import merkle_fr
from eigen_zeth_tpu_torch.ops import goldilocks as gl
from eigen_zeth_tpu_torch.ops import poseidon_fr as pfr

CPU = torch.device("cpu")
P = gl.P


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker: the workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(n, k=216, seed=0):
    rng = np.random.default_rng(seed + n)
    vals = rng.integers(0, P, (n, k), dtype=np.uint64)
    vals[0] = P - 1
    vals[1] = 0
    return vals


@pytest.mark.parametrize("n", [64, 256, 1024])
def test_commit_rows_gl_equals_jax(n):
    vals = _rows(n)
    want = jmfr.commit_rows_gl(jgl.from_int(vals))
    got = merkle_fr.commit_rows_gl(gl.from_int(vals, CPU))
    assert len(got.levels) == len(want.levels)
    for j in range(len(want.levels)):
        assert got.level_ints(j) == [int(v) for v in want.levels[j]]
    assert got.root() == want.root()
    idx = [0, 1, n // 2 + 3, n - 1]
    assert got.open_many(idx) == want.open_many(idx)


def test_transposed_rows_and_plain_versions_agree():
    vals = _rows(64, seed=7)
    cols = gl.from_int(np.ascontiguousarray(vals.T), CPU)
    t = merkle_fr.commit_rows_gl(cols.T)  # rows read through a transposed view
    digests = pfr.hash_rows_fr_plain(gl.from_int(vals, CPU))
    plain = [digests] + pfr.merkle_levels_fr_plain(digests)
    assert [t.level_ints(j) for j in range(len(plain))] == [pfr.ints_from_words(lv) for lv in plain]
    device_tree = merkle_fr.MerkleTreeFr(levels=plain)  # the form a card commit returns
    assert device_tree.open_many([5, 63]) == t.open_many([5, 63])
    assert device_tree.root() == t.root()


def test_verify_paths_accept_and_reject():
    vals = _rows(64, k=5, seed=3)
    t = merkle_fr.commit_rows_gl(gl.from_int(vals, CPU))
    root = t.root()
    for i in (0, 3, 63):
        row = [int(v) for v in vals[i]]
        path = t.open(i)
        assert merkle_fr.verify_path_gl(root, i, row, path)
        assert jmfr.verify_path_gl(root, i, row, path)
        assert merkle_fr.verify_path_packed(root, i, pfr.pack_gl_host(row), path)
    row0 = [int(v) for v in vals[0]]
    assert not merkle_fr.verify_path_gl(root, 0, [row0[0] + 1] + row0[1:], t.open(0))
    assert not merkle_fr.verify_path_gl(root, 1, row0, t.open(0))
    bad = t.open(0)
    bad[2] = (bad[2] + 1) % pfr.R
    assert not merkle_fr.verify_path_gl(root, 0, row0, bad)
    assert not merkle_fr.verify_path_gl(root, 0, row0, t.open(0)[:-1])


def test_commit_packed_host_equals_jax():
    rng = np.random.default_rng(9)
    packed = [[int.from_bytes(rng.bytes(32), "little") % pfr.R for _ in range(3)] for _ in range(8)]
    got, want = merkle_fr.commit_packed_host(packed), jmfr.commit_packed_host(packed)
    assert got.levels == want.levels and got.open(5) == want.open(5)


def test_jax_tree_converts_to_the_port_tree():
    from eigen_zeth_tpu_torch import convert

    vals = _rows(64, k=4, seed=11)
    want = jmfr.commit_rows_gl(jgl.from_int(vals))
    tree = convert.merkle_tree_fr_from(want.levels)
    assert tree.root() == want.root() and tree.open_many([3, 60]) == want.open_many([3, 60])
