"""The program's own spans in a traced run, for the readers of
`program_span` metrics that the program records itself.

The port's span tracer (`eigen_zeth_tpu_torch.utils.profiling`) records
while a torch.profiler session runs, so the traced window holds the
program's spans (its phases, on the host's clock) without a call from the
harness.  The first such reader of a run takes them from the tracer and
adds them to the record's spans, beside the harness's requests and the
stage hook's spans, where the breakdown's idle gaps find them too; the
tracer then holds none, and the readers after it find them in the record.
A program span is told from the harness's by its `parent`.  A program
without the tracer gives none, and its readers nothing.
"""


def spans(rec) -> list:
    rec.spans.extend(_take())
    return [s for s in rec.spans if hasattr(s, "parent")]


def _take() -> list:
    from eigen_zeth_tpu_torch.utils import profiling

    disable = getattr(profiling, "disable", None)
    return disable() if disable is not None else []


def inside(sp, name: str) -> bool:
    """Whether span `sp` lies inside a span named `name`."""
    p = sp.parent
    while p is not None:
        if p.name == name:
            return True
        p = p.parent
    return False


def per(rec, unit: str, names: tuple):
    """Seconds of the spans named in `names` that lie inside a `unit` span,
    summed over the run and divided by the number of `unit` spans; None
    where the run holds no `unit` span or none of those."""
    got = spans(rec)
    n = sum(s.name == unit for s in got)
    secs = [(s.end_ns - s.start_ns) / 1e9 for s in got if s.name in names and inside(s, unit)]
    if not n or not secs:
        return None
    return sum(secs) / n
