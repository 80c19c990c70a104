"""Seconds a step-2 request waits on the card: the program's
"device.read" spans (every blocking read of the card to the host, which
waits for the work queued before it) inside its "step2" spans, over the
count of "step2" spans.

No aggregate entry: that cell's stage hook (`air.STAGE_HOOK`) synchronises
the card at the end of every stage of an attestation, so its reads find
the card done and the waiting falls under the hook instead."""

from ._program import per


def read(rec):
    return per(rec, "step2", ("device.read",))
