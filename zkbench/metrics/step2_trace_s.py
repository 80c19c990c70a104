"""Seconds of step 2's trace phase a request (`stark_batch._trace_phase`,
the data's packing and the read of the chunks' `out`): the program's
"stark.trace" spans inside its "step2" spans, over the count of "step2"
spans.  Host time, the card not synchronised."""

from ._program import per


def read(rec):
    return per(rec, "step2", ("stark.trace",))
