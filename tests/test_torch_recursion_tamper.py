"""Chunk proofs that the port cannot attest, or attests only weakly.

The tamper cases of tests/test_recursion.py that run the attestation prover
to its end: a corrupted trace opening of the zero-layer child, a corrupted
fold-layer opening of the fold-layer child (both must raise from the FRI
degree check, as in the JAX package), and the one-query chunk whose honest
attestation verifies alone but not under the protocol's pin.  The chunk
proofs come from the same seeds as in tests/test_torch_recursion.py.
Tolerance: none.
"""

import pytest

from eigen_zeth_tpu_torch.models import recursion as rec
from eigen_zeth_tpu_torch.models import stark
from eigen_zeth_tpu_torch.protocol.prover_service import chunk_digest
from test_torch_recursion import (  # noqa: F401
    AGG_Q,
    CPU,
    SHAPES,
    P,
    _one_torch_thread,
    make_child,
)


@pytest.mark.parametrize("name", list(SHAPES))
def test_tampered_chunk_is_unattestable(name):
    """An aggregator holding a corrupted chunk proof cannot produce the
    attestation: the transcribed trace violates the verifier AIR and the
    prover's FRI degree check fires."""
    bad = make_child(name)
    if SHAPES[name][2] is None:
        row = bad["trace_openings"][0][0]["row"]
        row[0] = str((int(row[0]) + 1) % P)
    else:  # a fold-layer opening: the fold / select / Merkle constraints fire
        lay = bad["fri"]["queries"][0]["layers"][1]
        lay["u"] = str((int(lay["u"]) + 1) % P)
    with pytest.raises(AssertionError):
        rec.attest_chunk(bad, num_queries_agg=AGG_Q, device=CPU)


def test_weaker_attestation_is_rejected_under_the_protocols_pin():
    """A chunk proved with one query, attested honestly for q_c = 1, verifies
    alone but not under the 2-query protocol's pin."""
    weak = stark.StarkParams(blowup=4, num_queries=1, terminal_size=32)
    child = stark.prove_chunk([9, 9, 9], iv=5, params=weak, n_rows=8, device=CPU)
    att = rec.attest_chunk(child, num_queries_agg=AGG_Q, device=CPU)
    assert rec.verify_attestation(att) == chunk_digest(child)
    with pytest.raises(ValueError):
        rec.verify_attestation(att, expected_queries=2, expected_rows=8)
