"""The cell attest-wrap.stark-wrap-2leaf-grpc.wrap-pair driven through the
benchmark's harness on the CPU, at the small shape of
tests/zkbench_wrap_small.py: the server and the client in this process over
a loopback channel, step 2 over the stream, step 3's attestations the port's
own from the store (see that module), the envelope, the plain verifier and
the reference's check live.  A sound run comes out correct (the control
and the traced run are in tests/test_zkbench_wrap_control.py and
tests/test_zkbench_wrap_traced.py)."""

import pytest
import torch
import zkbench_wrap_small as small


@pytest.fixture(autouse=True)
def _store(monkeypatch):
    small.use_store(monkeypatch)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sound_run_is_correct():
    r = small.run(small.small_cell())
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["metrics"]["aggregate_s"]["value"] > 0 and r["metrics"]["setup_s"]["value"] > 0
