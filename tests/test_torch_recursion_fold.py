"""The checks of tests/test_torch_recursion.py on the fold-layer child.

A 32-row chunk with terminal 32: its FRI has two real fold layers, which the
verifier AIR checks with one more Merkle path each plus the fold, select and
index relations.  The chunk proof is made once and handed to the JAX package
and to the port; the test functions are the zero-layer file's, run here on
this file's `bundle` (the verifier trace's test takes both children in
tests/test_torch_recursion.py).  Tolerance: none (equal arrays, equal dicts).
"""

import pytest

from test_torch_recursion import (  # noqa: F401  (collected here, on this file's bundle)
    _one_torch_thread,
    make_bundle,
    test_attestation_is_identical_to_the_jax_package,
    test_each_verifier_accepts_the_others_attestation,
    test_host_helpers_are_the_jax_ones,
    test_query_count_rows_and_terminal_are_pinned,
    test_tampered_attestation_is_rejected,
)


@pytest.fixture(scope="module")
def bundle():
    return make_bundle("two-fold-layers")


def test_the_child_has_real_fold_layers(bundle):
    _, child, _, att = bundle
    assert len(child["fri"]["roots"]) == 2 and len(att["header"]["roots"]) == 2
    assert att["air_proof"]["air"] == "ezt-recursion/32/t32"
