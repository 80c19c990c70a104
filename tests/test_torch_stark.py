"""The port's batched chunk STARK against the JAX package's serial prover.

The JAX reference is `stark.prove_chunk` on its numpy path
(EZT_FORCE_NP_STARK=1: no XLA compile), one chunk at a time; the port
proves K chunks at once on CPU tensors.  Data and ivs come from numpy with
a fixed seed.  Tolerance: none — the proof dicts must be equal, field for
field, and both host verifiers must accept the port's proofs.
"""

import json

import numpy as np
import pytest

from eigen_zeth_tpu.models import stark as jstark
from eigen_zeth_tpu_torch.models import stark, stark_batch
from eigen_zeth_tpu_torch.ops import goldilocks as gl

K = 3
PARAMS = dict(num_queries=6)


def _chunks(n: int, seed: int):
    rng = np.random.default_rng(seed)
    datas = [
        [int(x) for x in rng.integers(0, gl.P, size=int(rng.integers(1, n)), dtype=np.uint64)]
        for _ in range(K)
    ]
    ivs = [int(x) for x in rng.integers(0, gl.P, size=K, dtype=np.uint64)]
    return datas, ivs


@pytest.fixture
def np_stark(monkeypatch):
    monkeypatch.setenv("EZT_FORCE_NP_STARK", "1")


@pytest.mark.parametrize("n", [16, 64])
def test_batched_proofs_equal_jax_serial(np_stark, n):
    datas, ivs = _chunks(n, n)
    want = [
        jstark.prove_chunk(d, iv, jstark.StarkParams(**PARAMS), n_rows=n)
        for d, iv in zip(datas, ivs)
    ]
    got = stark_batch.prove_chunks(datas, ivs, stark.StarkParams(**PARAMS), n=n, device="cpu")
    assert got == want
    assert json.dumps(got) == json.dumps(want)
    for proof in got:
        assert jstark.verify_chunk(proof, jstark.StarkParams(**PARAMS))
        assert stark.verify_chunk(proof, stark.StarkParams(**PARAMS))


def test_prove_chunk_is_the_single_chunk_batch(np_stark):
    datas, ivs = _chunks(16, 3)
    got = stark.prove_chunk(datas[0], ivs[0], stark.StarkParams(**PARAMS), device="cpu")
    assert got == jstark.prove_chunk(datas[0], ivs[0], jstark.StarkParams(**PARAMS))


def test_empty_chunk_matches_jax(np_stark):
    got = stark.prove_chunk([], 0, stark.StarkParams(**PARAMS), device="cpu")
    assert got == jstark.prove_chunk([], 0, jstark.StarkParams(**PARAMS))
    assert got["n"] == 4


def test_verifier_rejects_tampering(np_stark):
    datas, ivs = _chunks(16, 5)
    proof = stark_batch.prove_chunks(datas[:1], ivs[:1], stark.StarkParams(**PARAMS), n=16,
                                     device="cpu")[0]
    bad = json.loads(json.dumps(proof))
    bad["public"]["out"] = str((int(bad["public"]["out"]) + 1) % gl.P)
    assert not stark.verify_chunk(bad, stark.StarkParams(**PARAMS))
    assert not jstark.verify_chunk(bad, jstark.StarkParams(**PARAMS))
    bad = json.loads(json.dumps(proof))
    bad["trace_openings"][0][0]["row"][1] = "5"
    assert not stark.verify_chunk(bad, stark.StarkParams(**PARAMS))


def test_build_trace_is_the_jax_one():
    datas, ivs = _chunks(32, 7)
    assert stark.build_trace(datas[0], ivs[0], 32) == jstark.build_trace(datas[0], ivs[0], 32)
    # the device rolling hash agrees with the host recurrence
    proof = stark_batch.prove_chunks(datas, ivs, stark.StarkParams(**PARAMS), n=32, device="cpu")
    for k in range(K):
        assert int(proof[k]["public"]["out"]) == stark.build_trace(datas[k], ivs[k], 32)[2]
