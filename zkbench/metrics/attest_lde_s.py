"""Seconds of an attestation's lde stage, mean over the attestations of the
traced window (air.STAGE_HOOK)."""

from ._stages import mean


def read(rec):
    return mean(rec, "lde")
