"""The cell attest-wrap.stark-wrap-2leaf-grpc.wrap-pair on the CPU at the
small shape of tests/zkbench_wrap_small.py: the control, the port's
BatchProver with one wrap query fewer put in through `run_cell`'s `prover`,
comes out not correct, and a request's answers are the same with the
program's tracer on and off."""

import copy

import pytest
import torch
import zkbench_wrap_small as small

from eigen_zeth_tpu_torch.utils import profiling
from zkbench import harness
from zkbench import traffic as traffic_m

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _store(monkeypatch):
    small.use_store(monkeypatch)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    profiling.disable()


def test_control_is_not_correct():
    cell = small.small_cell()
    config = copy.deepcopy(cell["config"])
    config["prover"]["wrap_queries"] -= 1
    r = small.run(cell, prover=harness.make_prover(config, CPU), seconds=0.005)
    assert not r["correct"]
    assert r["checks"]["answers_differing"]["value"] > 0
    assert r["checks"]["requests_failed"]["value"] == 0


def test_answers_do_not_depend_on_the_tracer():
    cell = small.small_cell()
    drv = harness.driver_for(cell, harness.make_prover(cell["config"], CPU), CPU)
    try:
        req = traffic_m.request(small.SEED, 1, cell["traffic"], cell["config"])
        prepared = drv.prepare(req)
        off = drv.call(prepared)
        profiling.enable()
        drv.spans = []
        try:
            on = drv.call(prepared)
        finally:
            spans = profiling.disable()
            drv.spans = None
        # the answers are worked out from the returned string alone
        assert on.result_code == off.result_code == 0
        assert on.result_string == off.result_string
        ok, answers, _ = drv.answers(on)
        assert ok and answers[1:] == ["accepted", "accepted"]
        assert {"grpc.call", "grpc.handle", "step3"} <= {s.name for s in spans}
    finally:
        drv.close()
