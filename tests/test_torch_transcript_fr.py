"""The port's Fr transcript against the JAX package's.

The same absorb/squeeze sequences, made from a numpy seed, give the same
challenges (Fr, Goldilocks, indices) and the same grinding nonce at 0-6
bits: the least nonce that passes, on the host and through the batched
search that the card runs (here over kernel F's plain version on the CPU,
in small batches).  Tolerance: none.
"""

import numpy as np
import pytest
import torch

from eigen_zeth_tpu.models.transcript_fr import TranscriptFr as JTranscriptFr
from eigen_zeth_tpu_torch.models import transcript_fr
from eigen_zeth_tpu_torch.models.transcript_fr import TranscriptFr

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker: the workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(t, rng):
    out = []
    t.absorb("public", [int(v) for v in rng.integers(0, 2**63, 5)])
    out.append(t.challenge_fr("a"))
    t.absorb_packed_gl("gl", [int(v) for v in rng.integers(0, 2**63, 7)])
    out.append(t.challenge_gl("b"))
    out += t.challenges_gl("c", 3)
    out += t.challenge_indices("q", 4, 1 << 10)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_challenges_equal_jax(seed):
    got = _script(TranscriptFr("d"), np.random.default_rng(seed))
    want = _script(JTranscriptFr("d"), np.random.default_rng(seed))
    assert got == want


@pytest.mark.parametrize("bits", [0, 1, 3, 6])
@pytest.mark.parametrize("pad", [0, 8, 9, 10])
def test_grind_nonce_equals_jax(bits, pad):
    """pad places the nonce and the challenge label on every kind of lane,
    the last lanes of a rate block included."""
    t, jt = TranscriptFr("g"), JTranscriptFr("g")
    t.absorb("x", list(range(pad)))
    jt.absorb("x", list(range(pad)))
    nonce = t.grind(bits, device=CPU)
    assert nonce == jt.grind(bits)
    assert t._state == jt._state and t._pos == jt._pos
    for cand in range(nonce + 1):  # the nonce passes and no smaller one does
        v = TranscriptFr("g")
        v.absorb("x", list(range(pad)))
        assert v.grind_check(cand, bits) == (cand == nonce)


@pytest.mark.parametrize("pad", [0, 9, 10])
def test_batched_grind_search_finds_the_least_nonce(monkeypatch, pad):
    monkeypatch.setattr(transcript_fr, "GRIND_BATCH", 16)
    bits = 5
    t, jt = TranscriptFr("g"), JTranscriptFr("g")
    t.absorb("x", list(range(pad)))
    jt.absorb("x", list(range(pad)))
    assert transcript_fr._grind_device(list(t._state), t._pos, bits, CPU) == jt.grind(bits)
