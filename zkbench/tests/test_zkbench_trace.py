"""The traced run's reduction and the device readers on a made-up trace."""

import pytest

from zkbench import harness, trace
from zkbench.metrics import device_idle, kernel_e_roofline, step2_kernels_per_chunk
from zkbench.work import Work, least_seconds

E = "(anonymous namespace)::hash_rows_kernel(unsigned long const*, unsigned long*, long, " \
    "long, long, long, (anonymous namespace)::Consts)"
F = "(anonymous namespace)::hash_rows_kernel(unsigned long const*, unsigned long*, long, " \
    "long, long, long, ezt::fr::Fe)"


def op(name, s, e, kind="kernel"):
    return trace.DeviceOp(name, kind, s, e)


def test_union_gaps_and_names():
    ops = [op("a", 10, 30), op("b", 20, 40), op("c", 60, 70, "memcpy"), op("a", 95, 120)]
    window = (0, 100)
    assert trace.busy_intervals(ops, window) == [[10, 40], [60, 70], [95, 100]]
    assert trace.busy_seconds(ops, window) == 45e-9
    assert trace.idle_gaps(ops, window) == [(0, 10), (40, 60), (70, 95)]
    assert trace.time_by_name(ops, window) == {"a": 25e-9, "b": 20e-9, "c": 10e-9}


def test_idle_by_innermost_span():
    ops = [op("k", 10, 20), op("k", 50, 60)]
    # the request's span is recorded after its stages', as the harness does
    spans = [trace.Span("attest.trace", 0, 40), trace.Span("attest.lde", 40, 80),
             trace.Span("request", 0, 80)]
    got = trace.idle_by_span(ops, (0, 100), spans)
    want = {"attest.trace": 30e-9, "attest.lde": 30e-9, "between requests": 20e-9}
    assert got == pytest.approx(want)


def record(ops, requests, window=(0, 10**9)):
    return harness.Record(setup_s=1.0, window=window, requests=requests,
                          trace=trace.Trace(ops=ops, window=window))


def done(units, w):
    return harness.Done(index=0, start_ns=0, end_ns=10**9, units=units, ok=True,
                        digests=[], work=w)


def test_readers():
    w = Work(perms=10**6, nbytes=10**6)
    ops = [op(E, 0, 5 * 10**8), op(F, 0, 10**8), op("other", 6 * 10**8, 7 * 10**8),
           op("copy", 8 * 10**8, 9 * 10**8, "memcpy")]
    rec = record(ops, [done(4, w)])
    assert kernel_e_roofline.is_e(E) and not kernel_e_roofline.is_e(F)
    assert kernel_e_roofline.read(rec) == 100 * least_seconds(w)[0] / 0.5
    assert step2_kernels_per_chunk.read(rec) == 3 / 4
    assert abs(device_idle.read(rec) - 30.0) < 1e-9


def test_readers_find_nothing():
    rec = record([op("other", 0, 10)], [done(1, Work())])
    assert kernel_e_roofline.read(rec) is None
    rec.trace = None
    assert device_idle.read(rec) is None and step2_kernels_per_chunk.read(rec) is None
