"""Seconds of an attestation's grind stage (the wrap profile's proof of
work), mean over the attestations of the traced window (air.STAGE_HOOK)."""

from ._stages import mean


def read(rec):
    return mean(rec, "grind")
