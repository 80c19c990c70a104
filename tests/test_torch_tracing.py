"""The port's span tracer (`utils/profiling.py`) on the prover's steps.

At the test profile's shapes (16-row chunks, blowup 4, 2 queries, terminal
16, so chunk FRI commits two layers; the linear wrap) steps 1-4 run traced
on the CPU, and step 3 of the tiny recursion tier (8-row chunks, 8
attestation queries, mimc wrap) with its two attestations, the stage hook
set.  Off, the tracer records nothing; on, every phase has its span inside
its step's, every span carries its step's request id, the step spans count
their reads of the device, the proofs are byte for byte the untraced ones
(step 3 of the recursion tier: the golden sha256 the untraced port is held
to), `air.STAGE_HOOK` sees its stages in the same order, and a span shares
torch.profiler's clock.
"""

import hashlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from eigen_zeth_tpu_torch.models import air, air_wrap, recursion, stark
from eigen_zeth_tpu_torch.ops import goldilocks as gl
from eigen_zeth_tpu_torch.ops import kernels
from eigen_zeth_tpu_torch.protocol import prover_service as ps
from eigen_zeth_tpu_torch.protocol.messages import ProofResultCode
from eigen_zeth_tpu_torch.utils import profiling
from test_torch_air import _bounds, _toy_air, _toy_trace

CPU = torch.device("cpu")
REC = json.loads((Path(__file__).parent / "data" / "torch_slice_golden.json").read_text())[
    "recursion"]
RCFG = REC["config"]
CHAIN, ADDR = 12345, "0x1111111111111111111111111111111111111111"
STAGES = ["trace", "lde", "merkle", "composition", "fri", "openings"]

# the spans each traced step records (steps 1-4 at the test profile, step 3
# of the recursion tier)
SPANS = {
    "step1": {"step1"},
    "step2": {"step2", "step2.ivs", "stark.trace", "stark.commit", "stark.transcript",
              "stark.composition", "fri.layer", "fri.transcript", "fri.terminal", "fri.openings",
              "stark.openings", "step2.json", "device.read"},
    "step3": {"step3"},
    "step4": {"step4", "step4.witness", "step4.h", "step4.msm"},
    "step3-recursion": {"step3", "recursion.build", "recursion.replay", "recursion.perm_rows",
                        "recursion.paths", "recursion.coeffs", "recursion.upload",
                        "air.lde", "air.merkle",
                        "air.transcript", "air.composition", "air.fri", "air.openings",
                        "fri.layer", "fri.transcript", "fri.terminal", "fri.openings",
                        "device.read"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker: the workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracer_off():
    profiling.disable()
    yield
    profiling.disable()


def _sha(s: str) -> str:
    return hashlib.sha256(s.encode()).hexdigest()


def _ok(r):
    assert r.result_code == ProofResultCode.COMPLETED_OK, r.error_message
    return r


def _test_prover():
    return ps.BatchProver(stark_params=stark.StarkParams(blowup=4, num_queries=2, terminal_size=16),
                          chunk_trace_rows=16, recursion=False, wrap="linear", device=CPU)


def _steps(prover, traced: bool):
    """Steps 1-4 on blocks 1-2 as batch "b7"; each step's result and the
    spans recorded during it (none where `traced` is false)."""
    out = {}

    def step(name, fn, *args):
        if traced:
            profiling.enable()
        r = _ok(fn(*args))
        out[name] = (r, profiling.disable())
        return r

    r1 = step("step1", prover.gen_batch_chunks, "b7", [1, 2], CHAIN, "evm")
    r2 = step("step2", prover.gen_chunk_proof, "b7", r1.task_id, r1.chunk_count, CHAIN, "evm",
              r1.batch_data)
    r3 = step("step3", prover.gen_aggregated_proof, "b7", r2.chunk_proofs[0].proof,
              r2.chunk_proofs[-1].proof)
    step("step4", prover.gen_final_proof, "b7", r3.result_string, "BN128", ADDR)
    return out


@pytest.fixture(scope="module")
def linear_steps():
    """(untraced, traced) runs of steps 1-4 at the test profile."""
    prover = _test_prover()
    return _steps(prover, False), _steps(prover, True)


@pytest.fixture(scope="module")
def recursion_step3():
    """Step 3 of the tiny recursion tier, traced, with the stage hook
    recording: (result, spans, the hook's stage names)."""
    prover = ps.BatchProver(stark_params=stark.StarkParams(**RCFG["stark_params"]),
                            chunk_trace_rows=RCFG["chunk_trace_rows"],
                            agg_queries=RCFG["agg_queries"], wrap=RCFG["wrap"], device=CPU)
    blocks = RCFG["blocks"]
    r1 = _ok(prover.gen_batch_chunks("t", blocks, RCFG["chain_id"], "evm"))
    r2 = _ok(prover.gen_chunk_proof("t", r1.task_id, r1.chunk_count, RCFG["chain_id"], "evm",
                                    r1.batch_data))
    stages = []
    air.STAGE_HOOK = stages.append
    profiling.enable()
    try:
        r3 = _ok(prover.gen_aggregated_proof("t", r2.chunk_proofs[0].proof,
                                             r2.chunk_proofs[-1].proof))
    finally:
        air.STAGE_HOOK = None
        spans = profiling.disable()
    return r3, spans, stages


@pytest.fixture(params=sorted(SPANS))
def traced(request, linear_steps, recursion_step3):
    """(case, step, request id, spans) of one traced step."""
    if request.param == "step3-recursion":
        return request.param, "step3", "t", recursion_step3[1]
    r, spans = linear_steps[1][request.param]
    rid = r.task_id if request.param == "step2" else "b7"
    return request.param, request.param, rid, spans


def test_off_records_nothing(linear_steps):
    assert all(spans == [] for _, spans in linear_steps[0].values())
    assert profiling.span("step2") is profiling.span("fri.layer", layer=0)  # the shared no-op
    with profiling.span("step2") as sp:
        assert sp is None
    assert profiling.disable() == []


def test_each_step_records_its_spans(traced):
    case, _, _, spans = traced
    assert {s.name for s in spans} == SPANS[case]


def test_children_lie_inside_their_parents(traced):
    _, step, _, spans = traced
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == [step]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns and s.end_ns <= s.parent.end_ns, s.name


def test_every_span_carries_its_steps_request_id(traced):
    _, _, rid, spans = traced
    assert {s.request for s in spans} == {rid}


def test_step_spans_count_their_device_reads(traced):
    _, step, _, spans = traced
    (top,) = [s for s in spans if s.name == step]
    reads = [s for s in spans if s.name == "device.read"]
    assert top.attrs["device_reads"] == len(reads)
    assert top.attrs["read_bytes"] == sum(s.attrs["bytes"] for s in reads)
    assert top.attrs["hand_launches"] == {}  # no hand-written kernel on the CPU


def test_fri_layers_are_numbered(linear_steps):
    _, spans = linear_steps[1]["step2"]
    assert [s.attrs["layer"] for s in spans if s.name == "fri.layer"] == [0, 1]


@pytest.mark.parametrize("step", ["step1", "step2", "step3", "step4"])
def test_traced_answers_are_byte_identical(linear_steps, step):
    plain, traced = linear_steps
    a, b = plain[step][0], traced[step][0]
    if step == "step2":
        assert [c.proof for c in a.chunk_proofs] == [c.proof for c in b.chunk_proofs]
    elif step == "step4":
        assert (a.final_proof.proof, a.final_proof.public_input) == (
            b.final_proof.proof, b.final_proof.public_input)
    else:
        assert a == b


def test_traced_recursion_step3_is_the_golden_one(recursion_step3):
    r3, _, _ = recursion_step3
    assert _sha(r3.result_string) == REC["sha256"]["aggregated"]


def test_stage_hook_sees_the_same_stages(recursion_step3):
    _, spans, stages = recursion_step3
    assert stages == STAGES * 2
    assert sum(s.name == "recursion.build" for s in spans) == 2


def test_each_attestation_fills_its_rows_in_one_span(recursion_step3):
    """One "recursion.upload" and then one "recursion.perm_rows" inside each
    attestation's "recursion.build", the rows' span naming its slots, its
    states (slots x child queries) and where it ran."""
    _, spans, _ = recursion_step3
    sp = RCFG["stark_params"]
    rows = RCFG["chunk_trace_rows"]
    sch = recursion.Schedule(rows, min(rows * sp["blowup"], sp["terminal_size"]))
    slots = sum(sch.is_perm(s) for s in range(len(sch.slots)))
    builds = [s for s in spans if s.name == "recursion.build"]
    fills = [s for s in spans if s.name == "recursion.perm_rows"]
    uploads = [s for s in spans if s.name == "recursion.upload"]
    assert len(builds) == len(fills) == len(uploads) == 2
    for build, fill, upload in zip(builds, fills, uploads):
        assert fill.parent is build and upload.parent is build
        assert upload.end_ns <= fill.start_ns
        assert fill.attrs == {"slots": slots, "states": slots * sp["num_queries"],
                              "on_card": False}


def test_the_verifier_rows_kernels_are_not_es_in_its_roofline():
    """kernel_e_roofline counts E's permutations of the requests' Merkle
    commits; the verifier rows' kernels take E's constant block too, but
    their names, as the source declares them, are not E's."""
    from zkbench.metrics import kernel_e_roofline

    declared = re.compile(r"__global__ void __launch_bounds__\(\w+\)\s+(\w+)\(")

    def profiled(name):  # the demangled name the profiler gives a launch
        return f"(anonymous namespace)::{name}(unsigned long long*, long, ezt::poseidon2::Consts)"

    rows = declared.findall((kernels.CSRC / "poseidon2_gl_rows.cu").read_text())
    assert rows == ["verifier_walk_kernel", "verifier_rows_kernel"]
    assert not any(kernel_e_roofline.is_e(profiled(n)) for n in rows)
    e = declared.findall((kernels.CSRC / "poseidon2_gl.cu").read_text())
    assert len(e) == 4 and all(kernel_e_roofline.is_e(profiled(n)) for n in e)


def _toy(prover):
    n = 32
    rows, out = _toy_trace(n, 3, 5)
    bnds = _bounds(air, n, 3, 5, out)
    if prover == "air":
        return lambda: air.prove(_toy_air(air, n), gl.from_int(rows, CPU), [3, 5, out], bnds,
                                 num_queries=4)
    toy = _toy_air(air, n)
    toy.ext_blowup = 8
    return lambda: air_wrap.prove_wrap(toy, gl.from_int(rows, CPU), [3, 5, out], bnds,
                                       num_queries=2, grind_bits=2)


@pytest.mark.parametrize("prover", ["air", "wrap"])
def test_air_provers_span_each_stage_and_keep_the_hook(prover):
    prove = _toy(prover)
    plain = json.dumps(prove())
    stages = []
    air.STAGE_HOOK = stages.append
    profiling.enable()
    try:
        proof = json.dumps(prove())
    finally:
        air.STAGE_HOOK = None
        spans = profiling.disable()
    assert proof == plain
    want = ["lde", "merkle", "composition", "fri", "openings"]
    if prover == "wrap":
        want.insert(4, "grind")
    assert stages == want
    tops = [s.name for s in spans if s.parent is None]
    assert tops == ["air.lde", "air.merkle", "air.transcript", "air.composition", "air.fri",
                    "air.openings"]
    inner = {s.name for s in spans if s.parent is not None and s.parent.name == "air.fri"}
    assert inner == ({"fri.layer", "fri.terminal", "fri.openings"}
                     | ({"air.grind"} if prover == "wrap" else set()))


def test_a_span_shares_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    a = torch.arange(1 << 12, dtype=torch.int64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("probe") as sp:
            torch.bitwise_xor(a, a)
    assert sp is not None  # a running profiler turns the tracer on
    assert profiling.disable() == [sp]
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::bitwise_xor"]
    assert starts and all(sp.start_ns <= t <= sp.end_ns for t in starts)


def test_spans_of_threads_nest_apart():
    """Each thread has its own stack of open spans: a span opened on one
    thread is no parent of another thread's."""
    import threading

    profiling.enable()
    with profiling.span("step2", request="a"):
        done = threading.Event()

        def other():
            with profiling.span("step3", request="b"):
                pass
            done.set()

        threading.Thread(target=other).start()
        assert done.wait(10)
    spans = {s.name: s for s in profiling.disable()}
    assert spans["step3"].parent is None and spans["step3"].request == "b"


def test_a_failed_phase_still_closes_its_span():
    profiling.enable()
    with pytest.raises(ValueError):
        with profiling.span("step2"):
            with profiling.span("stark.trace"):
                raise ValueError("boom")
    with profiling.span("step3"):
        pass
    spans = {s.name: s for s in profiling.disable()}
    assert spans["step3"].parent is None
    assert spans["stark.trace"].parent is spans["step2"]


def test_array_reads_are_spanned():
    x = torch.tensor(np.arange(6, dtype=np.int64))
    profiling.enable()
    gl.to_int(x)
    (read,) = profiling.disable()
    assert (read.name, read.attrs) == ("device.read", {"bytes": 48})
