"""The cell attest-wrap.stark-wrap-2leaf-grpc.wrap-pair traced, on the CPU at
the small shape of tests/zkbench_wrap_small.py: a traced run through the
harness is correct and reads the gRPC hop from the program's spans."""

import pytest
import torch
import zkbench_wrap_small as small

from eigen_zeth_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _store(monkeypatch):
    small.use_store(monkeypatch)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    profiling.disable()


def test_traced_run_is_correct_and_reads_the_hop():
    r = small.run(small.small_cell(), traced=True, seconds=0.005)
    assert r["correct"], r["checks"]
    assert r["metrics"]["grpc_hop_s.attest_wrap"]["value"] > 0
    assert profiling.disable() == []
