"""The port's proving state machine against the JAX package's.

`ProverPipeline` checkpoints a step record in the rollup KV after every
transition (Start → GenChunks → GenChunkProof → Aggregate → Final → End),
resumes from it, retries a failed step and restarts on a stale record.
Each case runs the JAX package's pipeline and the port's on the same
prover and holds every value written to the database to the JAX one.
The prover is the port's `BatchProver` at the test profile on CPU tensors
for the full run, and a stub with the four steps (which counts its calls
and fails where told) for the resume and retry cases.  Tolerance: none,
records must be byte-identical.
"""

import json

import pytest
import torch

from eigen_zeth_tpu.protocol import kv as jkv
from eigen_zeth_tpu.protocol import state_machine as jsm
from eigen_zeth_tpu_torch.models import stark
from eigen_zeth_tpu_torch.protocol import kv, state_machine
from eigen_zeth_tpu_torch.protocol import prover_service as ps
from eigen_zeth_tpu_torch.protocol.messages import (
    ChunkProof,
    FinalProof,
    GenAggregatedProofResult,
    GenBatchChunksResult,
    GenChunkProofResult,
    GenFinalProofResult,
    ProofResultCode,
    make_task_id,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the run spreads files over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OK, ERR = ProofResultCode.COMPLETED_OK, ProofResultCode.COMPLETED_ERROR
STEPS = ("gen_batch_chunks", "gen_chunk_proof", "gen_aggregated_proof", "gen_final_proof")


class RecordingDb:
    """Wraps a database and logs every write: ("put", key, value) or
    ("delete", key)."""

    def __init__(self, db):
        self.db, self.log = db, []

    def get(self, key):
        return self.db.get(key)

    def put(self, key, value):
        self.log.append(("put", bytes(key), bytes(value)))
        self.db.put(key, value)

    def delete(self, key):
        self.log.append(("delete", bytes(key)))
        return self.db.delete(key)


class StubProver:
    """The four steps with fixed results: 3 chunks, so the aggregation tree
    has an odd tail.  fail[step] = n: the step's next n calls fail."""

    def __init__(self, fail=None):
        self.calls = dict.fromkeys(STEPS, 0)
        self.fail = dict(fail or {})

    def _code(self, step):
        self.calls[step] += 1
        if self.fail.get(step, 0) > 0:
            self.fail[step] -= 1
            return ERR
        return OK

    def gen_batch_chunks(self, batch_id, block_numbers, chain_id, program_name):
        code = self._code("gen_batch_chunks")
        return GenBatchChunksResult(batch_id, make_task_id(block_numbers[0]), code, 3,
                                    f"data-{block_numbers}-{chain_id}-{program_name}",
                                    bytes(range(32)), bytes(range(32, 64)),
                                    "" if code == OK else "no chunks")

    def gen_chunk_proof(self, batch_id, task_id, chunk_count, chain_id, program_name, batch_data):
        code = self._code("gen_chunk_proof")
        proofs = [ChunkProof(i, f"{task_id}/{i}", json.dumps({"type": "chunk", "i": i}))
                  for i in range(chunk_count)]
        return GenChunkProofResult(batch_id, task_id, code, proofs if code == OK else [],
                                   "" if code == OK else "no proofs")

    def gen_aggregated_proof(self, batch_id, recursive_proof_1, recursive_proof_2):
        code = self._code("gen_aggregated_proof")
        node = {"type": "aggregated", "children": [json.loads(recursive_proof_1),
                                                   json.loads(recursive_proof_2)]}
        return GenAggregatedProofResult(batch_id, code, json.dumps(node) if code == OK else "",
                                        "" if code == OK else "no aggregate")

    def gen_final_proof(self, batch_id, recursive_proof, curve_name, aggregator_addr):
        code = self._code("gen_final_proof")
        final = FinalProof(json.dumps({"wraps": recursive_proof, "curve": curve_name}),
                           json.dumps([aggregator_addr]))
        return GenFinalProofResult(batch_id, code, "", final if code == OK else None,
                                   "" if code == OK else "no final")


def _pipelines(prover_of, db_of=lambda side: kv.MemDb(), **kw):
    """(JAX pipeline, port pipeline), each on its own recording database and
    its own prover from prover_of()."""
    out = []
    for side, mod in (("jax", jsm), ("port", state_machine)):
        db = RecordingDb(db_of(side))
        out.append(mod.ProverPipeline(db, prover_of(), chain_id=12345, program_name="evm",
                                      aggregator_addr="0x" + "22" * 20, **kw))
    return out


def _result(r):
    return (r.block_number, r.proof, r.public_input, r.pre_state_root, r.post_state_root)


def test_step_records_equal_jax_after_every_transition():
    """The port's prover at the test profile; both machines write the same
    bytes at every transition and give the same ProofResult."""
    prover = ps.BatchProver(stark_params=stark.StarkParams(blowup=4, num_queries=2,
                                                           terminal_size=16),
                            wrap="linear", chunk_trace_rows=16, recursion=False,
                            device=torch.device("cpu"))
    jpipe, pipe = _pipelines(lambda: prover)
    want, got = jpipe.execute(5), pipe.execute(5)
    assert _result(got) == _result(want)
    assert json.loads(got.proof)["protocol"] == "groth16"
    steps = [json.loads(entry[2])["step"] for entry in pipe.db.log if entry[0] == "put"]
    assert steps == ["GenChunks", "GenChunkProof", "Aggregate", "Final", "End"]
    assert pipe.db.log == jpipe.db.log
    assert pipe.db.log[-1] == ("delete", kv.KEY_PROVE_STEP_RECORD)


def test_stub_run_with_an_odd_tail_equals_jax():
    jpipe, pipe = _pipelines(StubProver)
    assert _result(pipe.execute(9)) == _result(jpipe.execute(9))
    assert pipe.db.log == jpipe.db.log
    assert pipe.prover.calls == jpipe.prover.calls == {
        "gen_batch_chunks": 1, "gen_chunk_proof": 1, "gen_aggregated_proof": 2,
        "gen_final_proof": 1}


def test_a_failure_at_final_resumes_without_the_earlier_steps():
    """max_retries=0: the first run raises at Final with the record at
    Final; the second calls only gen_final_proof."""
    jpipe, pipe = _pipelines(lambda: StubProver({"gen_final_proof": 1}), max_retries=0)
    for p, err in ((jpipe, jsm.ProverError), (pipe, state_machine.ProverError)):
        with pytest.raises(err, match="no final"):
            p.execute(4)
        assert json.loads(p.db.get(kv.KEY_PROVE_STEP_RECORD))["step"] == "Final"
        before = dict(p.prover.calls)
        p.execute(4)
        assert {k: p.prover.calls[k] - before[k] for k in STEPS} == {
            "gen_batch_chunks": 0, "gen_chunk_proof": 0, "gen_aggregated_proof": 0,
            "gen_final_proof": 1}
    assert pipe.db.log == jpipe.db.log


@pytest.mark.parametrize("step", STEPS)
def test_prover_error_after_max_retries(step):
    jpipe, pipe = _pipelines(lambda: StubProver({step: 100}), max_retries=2)
    for p, err in ((jpipe, jsm.ProverError), (pipe, state_machine.ProverError)):
        with pytest.raises(err):
            p.execute(3)
        assert p.prover.calls[step] == 3
    assert pipe.prover.calls == jpipe.prover.calls
    assert pipe.db.log == jpipe.db.log


def test_a_stale_record_of_another_block_restarts():
    stale = state_machine.StepRecord(2, "Final", {"recursive_proof": "{}"}).to_json().encode()
    assert stale == jsm.StepRecord(2, "Final", {"recursive_proof": "{}"}).to_json().encode()
    jpipe, pipe = _pipelines(StubProver)
    for p in (jpipe, pipe):
        p.db.db.put(kv.KEY_PROVE_STEP_RECORD, stale)
        p.execute(7)
        assert all(p.prover.calls[s] >= 1 for s in STEPS)
    assert pipe.db.log == jpipe.db.log


def test_file_db_record_survives_a_reopen(tmp_path):
    """The record of a run cut at Aggregate is read back from the log file
    after a reopen, and the resumed run calls the steps from Aggregate on.
    Both packages' log files are byte-identical."""
    paths = {"jax": tmp_path / "jax.log", "port": tmp_path / "port.log"}
    opener = {"jax": jkv.FileDb, "port": kv.FileDb}
    jpipe, pipe = _pipelines(lambda: StubProver({"gen_aggregated_proof": 1}),
                             db_of=lambda side: opener[side](str(paths[side])), max_retries=0)
    for p in (jpipe, pipe):
        with pytest.raises(Exception, match="no aggregate"):
            p.execute(6)
        p.db.db.close()
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()

    db = kv.FileDb(str(paths["port"]))
    rec = state_machine.StepRecord.from_json(db.get(kv.KEY_PROVE_STEP_RECORD).decode())
    assert (rec.block_number, rec.step) == (6, "Aggregate")
    prover = StubProver()
    result = state_machine.ProverPipeline(db, prover, chain_id=12345, program_name="evm",
                                          aggregator_addr="0x" + "22" * 20).execute(6)
    db.close()
    assert prover.calls == {"gen_batch_chunks": 0, "gen_chunk_proof": 0,
                            "gen_aggregated_proof": 2, "gen_final_proof": 1}
    assert result.pre_state_root == bytes(range(32))
    db = kv.FileDb(str(paths["port"]))
    assert db.get(kv.KEY_PROVE_STEP_RECORD) is None
    db.close()


def test_open_db_kinds(tmp_path):
    assert isinstance(kv.open_db("memory"), kv.MemDb)
    with pytest.raises(ValueError, match="path"):
        kv.open_db("native")
    db = kv.open_db("native", str(tmp_path / "n.log"))
    assert type(db).__name__ == "NativeDb"
    db.close()
    with pytest.raises(ValueError, match="path"):
        kv.open_db("file")
