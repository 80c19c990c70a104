"""The check that decides `correct`, driven through the harness on the CPU
at a size a test run holds (8-row chunks for step 3, 16-row for step 2;
the cells' traffic otherwise as committed):

  * a sound run of the program comes out correct;
  * the control, the plain reference in the program's place with one query
    fewer in the step the cell drives, comes out not correct;
  * a run with the program's timed path broken underneath comes out not
    correct, for each fault the cells can have: an answer altered where it
    is produced; half of the batch left out, the rest standing in for it;
    a step that returns its state unchanged (the previous request's answer);
    and a step that fails, which the service answers with COMPLETED_ERROR.
    The exchange between chips has no place in a one-chip cell.
"""

import copy
import importlib
import json
import time

import pytest
import torch

from zkbench import harness
from zkbench import traffic as traffic_m
from zkbench.control import ReferenceProver

AGG, CHUNKS = "aggregate.recursion-mimc.pair", "chunks.stark-wrap-2leaf.block-30m"
SMALL = {
    AGG: ({"chunk_trace_rows": 8, "agg_queries": 8,
           "stark_params": {"blowup": 4, "num_queries": 2, "terminal_size": 32}}, 7),
    CHUNKS: ({"chunk_trace_rows": 16,
              "stark_params": {"blowup": 4, "num_queries": 2, "terminal_size": 16}}, 15),
}
SEED = (1 << 31) + 977


def small_cell(name: str) -> dict:
    """The cell at a small chunk shape; its payload scaled with the chunk, so
    that it fills as many chunks, the last as partly, as the cell's does."""
    cell = copy.deepcopy(harness.load_cell(name))
    prover, elems = SMALL[name]
    traffic = cell["traffic"]
    chunks = traffic_m.chunk_count(traffic, cell["config"])
    traffic["payload_bytes"] = -(-traffic["payload_bytes"] * elems // cell["config"]["chunk_elems"])
    cell["config"]["prover"].update(copy.deepcopy(prover))
    cell["config"]["chunk_elems"] = elems
    assert traffic_m.chunk_count(traffic, cell["config"]) == chunks
    return cell


def run(cell: dict, prover=None) -> dict:
    return harness.run_cell(cell, SEED, 0.01, False, torch.device("cpu"),
                            t_start=time.perf_counter(), prover=prover, log=lambda m: None)


@pytest.mark.parametrize("name", [CHUNKS, AGG])
def test_sound_run_is_correct(name):
    r = run(small_cell(name))
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("name", [CHUNKS, AGG])
def test_control_is_not_correct(name):
    cell = small_cell(name)
    r = run(cell, ReferenceProver(cell["config"], cell["traffic"]["entry"], torch.device("cpu")))
    assert not r["correct"]
    assert r["checks"]["answers_differing"]["value"] > 0


def _altered_chunks(monkeypatch):
    from eigen_zeth_tpu_torch.models import stark_batch

    real = stark_batch.prove_chunks

    def prove_chunks(*a, **kw):
        proofs = real(*a, **kw)
        c = proofs[-1]["fri"]["final_coeffs"]
        c[0] = str((int(c[0]) + 1) % 0xFFFFFFFF00000001)
        return proofs

    monkeypatch.setattr(stark_batch, "prove_chunks", prove_chunks)


def _half_chunks(monkeypatch):
    from eigen_zeth_tpu_torch.models import stark_batch

    real = stark_batch.prove_chunks

    def prove_chunks(datas, ivs, *a, **kw):
        half = max(1, len(datas) // 2)
        proofs = real(datas[:half], ivs[:half], *a, **kw)
        return (proofs * 2)[: len(datas)]

    monkeypatch.setattr(stark_batch, "prove_chunks", prove_chunks)


def _stale(method):
    def patch(monkeypatch):
        from eigen_zeth_tpu_torch.protocol import prover_service as ps

        real, first = getattr(ps.BatchProver, method), []

        def step(self, *a, **kw):
            if not first:
                first.append(real(self, *a, **kw))
            return first[0]

        monkeypatch.setattr(ps.BatchProver, method, step)

    return patch


def _altered_attestation(monkeypatch):
    from eigen_zeth_tpu_torch.models import recursion

    real = recursion.attest_chunk

    def attest_chunk(*a, **kw):
        att = real(*a, **kw)
        att["air_proof"]["fri"]["final_coeffs"][0] = str(
            (int(att["air_proof"]["fri"]["final_coeffs"][0]) + 1) % 0xFFFFFFFF00000001)
        return att

    monkeypatch.setattr(recursion, "attest_chunk", attest_chunk)


def _half_pair(monkeypatch):
    from eigen_zeth_tpu_torch.protocol import prover_service as ps

    real = ps.BatchProver.gen_aggregated_proof

    def step(self, batch_id, p1, p2):
        return real(self, batch_id, p1, p1)

    monkeypatch.setattr(ps.BatchProver, "gen_aggregated_proof", step)


def _raises(module, name):
    def patch(monkeypatch):
        mod = importlib.import_module(f"eigen_zeth_tpu_torch.models.{module}")

        def broken(*a, **kw):
            raise RuntimeError("a kernel launch failed")

        monkeypatch.setattr(mod, name, broken)

    return patch


FAULTS = [
    (CHUNKS, "altered", _altered_chunks),
    (CHUNKS, "half", _half_chunks),
    (CHUNKS, "stale", _stale("gen_chunk_proof")),
    (CHUNKS, "error", _raises("stark_batch", "prove_chunks")),
    (AGG, "altered", _altered_attestation),
    (AGG, "half", _half_pair),
    (AGG, "stale", _stale("gen_aggregated_proof")),
    (AGG, "error", _raises("recursion", "attest_chunk")),
]


@pytest.mark.parametrize("name,fault,patch", FAULTS, ids=[f"{n}-{f}" for n, f, _ in FAULTS])
def test_fault_is_not_correct(monkeypatch, name, fault, patch):
    patch(monkeypatch)
    r = run(small_cell(name))
    assert not r["correct"], r["checks"]
    if fault == "error":
        assert r["checks"]["requests_failed"]["value"] > 0
    else:
        assert r["checks"]["answers_differing"]["value"] > 0


def test_answers_are_the_service_strings():
    """The chunk cell's answers carry every field of the returned proofs."""
    cell = small_cell(CHUNKS)
    drv = harness.driver_for(cell, harness.make_prover(cell["config"], "cpu"), "cpu")
    req = traffic_m.request(SEED, 5, cell["traffic"], cell["config"])
    ok, answers, _ = drv.answers(drv.call(drv.prepare(req)))
    assert ok and len(answers) == req.chunk_count == 13
    chunk_id, key, proof = json.loads(answers[3])
    assert chunk_id == 3 and key == f"{req.task_id}/3"
    assert json.loads(proof)["type"] == "chunk"
