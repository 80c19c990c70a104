"""The readers of the wrap cell's new per-layer metrics on made-up records,
and kernel F's work (zkbench/work_fr.py) at the node's wrap shape:

  * grpc_hop_s: a request's "grpc.call" less its "grpc.handle", paired by
    request id and kind, mean over the pairs; nothing without a pair;
  * kernel_f_roofline: F's least time over its kernels' device time in the
    window, E's kernels (those taking `Consts`) and its verifier rows left
    out; nothing without an F kernel;
  * attest_grind_s: the mean of the stage hook's "attest.grind" spans;
  * F's permutation count and multiply-adds, whose leaf sponge over the
    (2^23, 216) rows is the 531.35 ms bound of F's row in PERF.md.
"""

import pytest

from eigen_zeth_tpu_torch.utils import profiling
from zkbench import harness, trace, work_fr
from zkbench.metrics import attest_grind_s, grpc_hop_s, kernel_f_roofline
from zkbench.work import Work

MS = 10**6


def record(spans=(), ops=(), requests=(), window=(0, 10**10)):
    return harness.Record(setup_s=1.0, window=window, requests=list(requests), spans=list(spans),
                          trace=trace.Trace(ops=list(ops), window=window))


def pair(request, kind, call, handle):
    """A client call and its handle, (start, end) in milliseconds each."""
    c = profiling.Span("grpc.call", call[0] * MS, call[1] * MS, request=request,
                       attrs={"kind": kind})
    h = profiling.Span("grpc.handle", handle[0] * MS, handle[1] * MS, request=request,
                       attrs={"kind": kind})
    return [c, h]


def test_grpc_hop_pairs_call_and_handle():
    spans = (pair("b-1", "gen_aggregated_proof", (0, 100), (4, 94))
             + pair("b-2", "gen_aggregated_proof", (200, 300), (202, 298))
             + [profiling.Span("grpc.call", 400 * MS, 500 * MS, request="b-3",
                               attrs={"kind": "gen_aggregated_proof"})])
    assert grpc_hop_s.read(record(spans)) == pytest.approx(0.007)
    other_kind = pair("b-4", "gen_chunk_proof", (0, 10), (1, 9))
    other_kind[1].attrs["kind"] = "gen_aggregated_proof"
    assert grpc_hop_s.read(record(other_kind)) is None
    assert grpc_hop_s.read(record([trace.Span("request", 0, 10)])) is None


def test_kernel_f_roofline_reads_f_alone():
    w = Work(perms=10**6)
    least, why = work_fr.least_seconds(w)
    assert why == "operations"
    f_ns = int(least * 2e9)  # F at half its roofline
    ops = [trace.DeviceOp("(anonymous namespace)::hash_rows_kernel(unsigned long const*, "
                          "unsigned long*, long, long, long, long, ezt::fr::Fe)", "kernel",
                          0, f_ns // 2),
           trace.DeviceOp("(anonymous namespace)::merkle_levels_kernel(unsigned long const*)",
                          "kernel", f_ns, f_ns + f_ns // 2),
           trace.DeviceOp("(anonymous namespace)::hash_rows_kernel(unsigned long const*, "
                          "(anonymous namespace)::Consts)", "kernel", 0, 5 * f_ns),
           trace.DeviceOp("verifier_rows_kernel(unsigned long*)", "kernel", 0, 5 * f_ns),
           trace.DeviceOp("Memcpy HtoD", "memcpy", 0, 5 * f_ns)]
    done = [harness.Done(0, 0, 1, 2, True, [], w)]
    assert kernel_f_roofline.read(record(ops=ops, requests=done)) == pytest.approx(50.0, rel=1e-6)
    assert kernel_f_roofline.read(record(ops=ops[2:], requests=done)) is None


def test_attest_grind_reads_the_stage():
    spans = [trace.Span("attest.grind", 0, 20 * MS), trace.Span("attest.grind", 50 * MS, 90 * MS),
             trace.Span("attest.fri", 0, 50 * MS)]
    assert attest_grind_s.read(record(spans)) == pytest.approx(0.030)
    assert attest_grind_s.read(record(spans[2:])) is None


def test_f_work_at_the_node_shape():
    assert work_fr.MADS_PER_PERM_FR == 151_568
    assert work_fr.perms_per_row(216) == 7 and work_fr.perms_per_row(2) == 1
    m = 1 << 23
    w = work_fr.wrap_attestation(1 << 18, 216, 32)
    fri = sum(s // 2 + s // 2 - 1 for s in (m >> i for i in range(17)))  # layers down to 64
    assert w.perms == m * 7 + m - 1 + fri
    leaves, _ = work_fr.least_seconds(Work(perms=m * 7))
    assert leaves * 1e3 == pytest.approx(531.35, abs=0.01)
