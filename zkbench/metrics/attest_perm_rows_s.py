"""Seconds an attestation's verifier-trace build spends in the host's
Poseidon2 rows (`recursion._perm_rows_np` and the columns it fills, one
"recursion.perm_rows" span a permutation slot): their sum over the count
of "recursion.build" spans, one an attestation."""

from ._program import per


def read(rec):
    return per(rec, "recursion.build", ("recursion.perm_rows",))
