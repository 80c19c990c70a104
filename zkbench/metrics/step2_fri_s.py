"""Seconds of step 2's FRI commit phase a request: the program's
"fri.layer" spans (each committed layer's tree, root read, transcripts and
fold) and "fri.terminal" spans inside its "step2" spans, over the count of
"step2" spans.  FRI's openings are left out."""

from ._program import per


def read(rec):
    return per(rec, "step2", ("fri.layer", "fri.terminal"))
