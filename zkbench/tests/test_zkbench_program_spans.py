"""The readers of the program's own spans on made-up records, and a traced
run of the chunk cell through the harness on the CPU, whose record takes
the program's spans."""

import time

import pytest
import torch

from eigen_zeth_tpu_torch.utils import profiling
from zkbench import harness, trace
from zkbench.metrics import (
    attest_perm_rows_s,
    host_wait_s,
    step2_composition_s,
    step2_fri_s,
    step2_trace_s,
)

MS = 10**6


def sp(name, s, e, parent=None, **attrs):
    """A program span from s to e milliseconds."""
    return profiling.Span(name, s * MS, e * MS, parent=parent, attrs=attrs)


def step2_request(t0):
    """The spans of one step-2 request starting at t0 ms, 100 ms long."""
    step = sp("step2", t0, t0 + 100)
    out = [step]
    trace_ = sp("stark.trace", t0, t0 + 20, step)
    out += [trace_, sp("device.read", t0 + 18, t0 + 20, trace_, bytes=104),
            sp("stark.composition", t0 + 30, t0 + 45, step)]
    for i in range(2):
        layer = sp("fri.layer", t0 + 45 + 10 * i, t0 + 55 + 10 * i, step, layer=i)
        out += [layer, sp("device.read", t0 + 48 + 10 * i, t0 + 51 + 10 * i, layer, bytes=416)]
    out += [sp("fri.terminal", t0 + 65, t0 + 70, step)]
    return out


def record(spans, ops=(), window=(0, 10**9)):
    return harness.Record(setup_s=1.0, window=window, requests=[], spans=list(spans),
                          trace=trace.Trace(ops=list(ops), window=window))


def test_step2_readers():
    rec = record(step2_request(0) + step2_request(200))
    assert step2_trace_s.read(rec) == pytest.approx(0.020)
    assert step2_composition_s.read(rec) == pytest.approx(0.015)
    assert step2_fri_s.read(rec) == pytest.approx(0.025)
    assert host_wait_s.read(rec) == pytest.approx(0.008)


def test_reads_outside_step2_are_not_its_wait():
    stray = sp("device.read", 500, 600, bytes=8)  # outside every step-2 span
    rec = record(step2_request(0) + [stray])
    assert host_wait_s.read(rec) == pytest.approx(0.008)


def test_perm_rows_reader():
    spans = []
    for t0 in (0, 1000):
        build = sp("recursion.build", t0, t0 + 900)
        paths = sp("recursion.paths", t0 + 10, t0 + 800, build)
        spans += [build, paths] + [sp("recursion.perm_rows", t0 + 10 + 30 * i, t0 + 35 + 30 * i,
                                      paths) for i in range(20)]
    spans.append(sp("recursion.perm_rows", 5000, 5100))  # outside every build
    assert attest_perm_rows_s.read(record(spans)) == pytest.approx(0.5)


@pytest.mark.parametrize("reader", [step2_trace_s, step2_composition_s, step2_fri_s, host_wait_s,
                                    attest_perm_rows_s], ids=lambda m: m.__name__.split(".")[-1])
def test_readers_find_nothing(reader):
    assert reader.read(record([])) is None
    # the harness's own spans alone: no program span
    assert reader.read(record([trace.Span("request", 0, 10), trace.Span("attest.trace", 0, 5)])) \
        is None


def test_step2_readers_need_a_step2_span():
    orphans = [s for s in step2_request(0) if s.name != "step2"]
    for s in orphans:
        if s.parent is not None and s.parent.name == "step2":
            s.parent = None
    rec = record(orphans)
    assert step2_trace_s.read(rec) is None and host_wait_s.read(rec) is None


def test_idle_falls_under_a_program_span_nested_in_a_request():
    spans = step2_request(0)
    rec = record([trace.Span("request", 0, 100 * MS)] + spans, window=(0, 100 * MS))
    ops = [trace.DeviceOp("k", "kernel", 20 * MS, 30 * MS), trace.DeviceOp("k", "kernel", 70 * MS,
                                                                           100 * MS)]
    got = trace.idle_by_span(ops, rec.window, rec.spans)
    want = {"stark.trace": 0.018, "device.read": 0.008, "stark.composition": 0.015,
            "fri.layer": 0.014, "fri.terminal": 0.005}
    assert got == pytest.approx(want)
    assert "request" not in got and "step2" not in got


def test_the_first_reader_takes_the_tracers_spans():
    profiling.enable()
    with profiling.span("step2", request="7"):
        with profiling.span("stark.trace"):
            pass
    rec = record([trace.Span("request", 0, 10)])
    assert step2_trace_s.read(rec) is not None
    assert [s.name for s in rec.spans] == ["request", "stark.trace", "step2"]
    assert profiling.disable() == []  # the tracer holds none now
    assert step2_trace_s.read(rec) is not None  # the next reader finds them in the record


class CpuProfiler(trace.Profiler):
    """The harness's profiler with the host's activity, as the CPU has no
    card: the program's tracer records under it as under the card's."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU])

    def ops(self) -> list:
        return []


def test_traced_run_reports_the_program_spans(monkeypatch):
    from test_zkbench_check import CHUNKS, SEED, small_cell

    monkeypatch.setattr(trace, "Profiler", CpuProfiler)
    r = harness.run_cell(small_cell(CHUNKS), SEED, 0.01, True, torch.device("cpu"),
                         t_start=time.perf_counter(), log=lambda m: None)
    assert r["correct"], r["checks"]
    for name in ("step2_trace_s.chunks", "step2_composition_s.chunks", "step2_fri_s.chunks",
                 "host_wait_s.chunks"):
        assert r["metrics"][name]["value"] > 0, name
    # no card: the whole window is idle, and it falls under the program's spans
    idle = dict(r["breakdown"]["idle_gaps"])
    assert "stark.trace" in idle and "fri.layer" in idle
    assert profiling.disable() == []
