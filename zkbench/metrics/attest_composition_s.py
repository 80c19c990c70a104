"""Seconds of an attestation's composition stage, mean over the attestations of the
traced window (air.STAGE_HOOK)."""

from ._stages import mean


def read(rec):
    return mean(rec, "composition")
