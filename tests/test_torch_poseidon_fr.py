"""The port's Poseidon2-Fr against the JAX package's host functions.

Kernel F's plain versions (`perm_fr_plain`, `hash_rows_fr_plain`,
`merkle_levels_fr_plain`, on CPU tensors), the port's host functions and
its host batches are held against the JAX package's `perm_host`,
`hash_elements_host`, `hash_two_host` and `pack_gl_host` on states made
from a numpy seed, with edge lanes: zeros, r - 1, and p - 1 Goldilocks
values.  The JAX package's device permutation is not run here: its XLA
compile takes about 15 minutes on the CPU (tests/test_air_wrap.py marks it
slow).  Tolerance: none, every value must be equal.
"""

import numpy as np
import pytest
import torch

from eigen_zeth_tpu.ops import poseidon_fr as jpfr
from eigen_zeth_tpu_torch.ops import goldilocks as gl
from eigen_zeth_tpu_torch.ops import kernels
from eigen_zeth_tpu_torch.ops import poseidon_fr as pfr

CPU = torch.device("cpu")
R = pfr.R
P = gl.P


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker: the workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(seed, n):
    rng = np.random.default_rng(seed)
    out = [[int.from_bytes(rng.bytes(32), "little") % R for _ in range(12)] for _ in range(n)]
    out[0] = [0] * 12
    out[1] = [R - 1] * 12
    out[2] = [P - 1] * 6 + [R - 1] * 6
    return out


def test_instance_constants_are_the_jax_ones():
    assert pfr.round_constants() == jpfr.round_constants()
    assert pfr.internal_diag() == jpfr.internal_diag()
    assert (pfr.WIDTH, pfr.RATE, pfr.FULL_ROUNDS, pfr.PARTIAL_ROUNDS, pfr.GL_PACK) == (
        jpfr.WIDTH, jpfr.RATE, jpfr.FULL_ROUNDS, jpfr.PARTIAL_ROUNDS, jpfr.GL_PACK)
    assert pfr._sha_to_fr("ezt-pfr-sponge/leaf") == jpfr._sha_to_fr("ezt-pfr-sponge/leaf")


@pytest.mark.parametrize("seed", [1, 2])
def test_perm_host_and_batch_equal_jax(seed):
    states = _states(seed, 6)
    want = [jpfr.perm_host(s) for s in states]
    assert [pfr.perm_host(s) for s in states] == want
    got = pfr.perm_host_batch(np.array(states, dtype=object))
    assert [[int(v) for v in row] for row in got] == want


def test_perm_plain_device_form_equals_jax_host():
    states = _states(3, 5)
    got = pfr.perm_device(pfr.words_from_ints(states, CPU))  # CPU: the plain version
    assert kernels.LAUNCHES["poseidon_fr"] == 0
    assert [pfr.ints_from_words(got[i]) for i in range(len(states))] == [
        jpfr.perm_host(s) for s in states]


@pytest.mark.parametrize("n", [0, 1, 10, 11, 12, 23, 72])
def test_hash_elements_and_batch_equal_jax(n):
    rng = np.random.default_rng(10 + n)
    elems = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    if n:
        elems[0] = R - 1
    for tag in ("leaf", "x/y"):
        want = jpfr.hash_elements_host(elems, tag=tag)
        assert pfr.hash_elements_host(elems, tag=tag) == want
        rows = np.array([elems, elems], dtype=object).reshape(2, n)
        assert [int(v) for v in pfr.hash_rows_host(rows, tag=tag)] == [want, want]


def test_hash_two_equals_jax():
    rng = np.random.default_rng(4)
    for left, right in [(0, 0), (R - 1, 1)] + [
        (int.from_bytes(rng.bytes(32), "little") % R, int.from_bytes(rng.bytes(32), "little") % R)
        for _ in range(3)
    ]:
        assert pfr.hash_two_host(left, right) == jpfr.hash_two_host(left, right)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 7, 216])
def test_pack_gl_host_and_device_equal_jax(k):
    rng = np.random.default_rng(20 + k)
    vals = rng.integers(0, P, (5, k), dtype=np.uint64)
    vals[0] = P - 1
    vals[1] = 0
    ints = [[int(v) for v in row] for row in vals]
    want = [jpfr.pack_gl_host(row) for row in ints]
    assert [pfr.pack_gl_host(row) for row in ints] == want
    assert [[int(v) for v in row] for row in pfr.pack_gl_rows_host(vals)] == want
    dev = pfr.pack_gl_device(gl.from_int(vals, CPU))  # (5, ceil(k/3), 4) words
    assert [pfr.ints_from_words(dev[i]) for i in range(5)] == want


@pytest.mark.parametrize("k", [2, 25, 216])
def test_hash_rows_plain_equals_jax_leaf_sponge(k):
    rng = np.random.default_rng(30 + k)
    vals = rng.integers(0, P, (6, k), dtype=np.uint64)
    vals[0] = P - 1
    vals[1] = 0
    got = pfr.ints_from_words(pfr.hash_rows_fr_plain(gl.from_int(vals, CPU)))
    want = [jpfr.hash_elements_host(jpfr.pack_gl_host([int(v) for v in row]), tag="leaf")
            for row in vals]
    assert got == want


@pytest.mark.parametrize("n", [1, 2, 8])
def test_merkle_levels_plain_and_host_equal_jax(n):
    rng = np.random.default_rng(40 + n)
    leaves = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    want, cur = [], leaves
    while len(cur) > 1:
        cur = [jpfr.hash_two_host(cur[i], cur[i + 1]) for i in range(0, len(cur), 2)]
        want.append(cur)
    plain = pfr.merkle_levels_fr_plain(pfr.words_from_ints(leaves, CPU).reshape(n, 4))
    assert [pfr.ints_from_words(lv) for lv in plain] == want
    host = pfr.merkle_levels_host(np.array(leaves, dtype=object))
    assert [[int(v) for v in lv] for lv in host] == want


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA entries take CUDA tensors only: a CPU tensor goes to the
    plain version through `perm_device`, never to a wrapper."""
    words = pfr.words_from_ints([[0] * 12], CPU)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.poseidon_fr_perm(words)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.poseidon_fr_hash_rows(torch.zeros((4, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.poseidon_fr_merkle_levels(torch.zeros((4, 4), dtype=torch.int64))


def test_constant_words_are_montgomery_forms():
    from eigen_zeth_tpu_torch.ops import bn254

    words = kernels.poseidon_fr_const_words()
    vals = [sum(words[8 * i + j] << (32 * j) for j in range(8)) for i in range(len(words) // 8)]
    ctx = bn254.fr()
    rc = pfr.round_constants()
    assert len(vals) == 8 * 12 + 68 + 12 + 1
    assert vals[0] == rc[0][0] * ctx.R_mod % R
    assert vals[8 * 12] == rc[4][0] * ctx.R_mod % R
    assert vals[-2] == pfr.internal_diag()[-1] * ctx.R_mod % R
    assert vals[-1] == ctx.R2_mod


def test_fr_limb_planes_convert_to_words():
    from eigen_zeth_tpu_torch import convert

    vals = [0, 1, R - 1, 2**200 + 5]
    ctx = jpfr._ctx()
    got = convert.fr_words_from_limbs(np.asarray(ctx.from_int(np.array(vals, dtype=object))), CPU)
    assert pfr.ints_from_words(got) == vals
    raw = convert.fr_words_from_limbs(np.asarray(ctx.from_int(np.array(vals, dtype=object),
                                                              mont=False)), CPU, mont=False)
    assert pfr.ints_from_words(raw) == vals


def test_multiply_add_count_of_the_bound_matches_the_permutation(monkeypatch):
    """chip_smoke.py bounds kernel F by 980 Montgomery products and 328
    squarings a permutation (MADS_PER_PERM_FR): the plain permutation, a
    copy of the JAX package's `_perm_device_run`, makes exactly 1,308
    products a state (the squarings among them: x·x), besides the 24 that
    enter and leave Montgomery form."""
    import chip_smoke

    ctx = pfr._ctx()
    real = ctx.mont_mul_plain
    counts = {"products": 0, "squarings": 0}

    def counting(a, b):
        n = max(a.numel(), b.numel()) // 16
        counts["products"] += n
        if a.data_ptr() == b.data_ptr() and a.shape == b.shape:
            counts["squarings"] += n
        return real(a, b)

    monkeypatch.setattr(ctx, "mont_mul_plain", counting)
    pfr.perm_fr_plain(pfr.words_from_ints([list(range(12))], CPU))
    assert counts["products"] - 24 == chip_smoke.FR_MULS_PER_PERM + chip_smoke.FR_SQRS_PER_PERM
    assert counts["squarings"] == chip_smoke.FR_SQRS_PER_PERM
    assert chip_smoke.MADS_PER_PERM_FR == 980 * 136 + 328 * 108 == 168_704
