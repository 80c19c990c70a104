"""Seconds of an attestation's trace stage, mean over the attestations of the
traced window (air.STAGE_HOOK)."""

from ._stages import mean


def read(rec):
    return mean(rec, "trace")
