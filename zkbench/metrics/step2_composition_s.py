"""Seconds of step 2's composition a request: the program's
"stark.composition" spans inside its "step2" spans, over the count of
"step2" spans.  Host time: the launches; the card's own time for them
shows in the next read, in FRI's first layer."""

from ._program import per


def read(rec):
    return per(rec, "step2", ("stark.composition",))
