"""The port's chunk axis and its twins of `__graft_entry__.py`'s entry points
against the JAX package, on CPU shards (a device repeated: logical shards,
one controller).

- `prove_chunks(mesh=)` with K = 3 on a 2-way chunk axis: byte for byte the
  serial proofs and the JAX package's `stark.prove_chunk`; `BatchProver(mesh=)`
  step 2 byte for byte its serial step 2.
- `dryrun_multichip(4)`; `entry()`'s root against the JAX package's host
  NTT, sponge and compression; `profile_trace` around it (a Chrome trace
  in the directory, or in $EZT_PROFILE_DIR; none without either).
Tolerance: none, exact integer and byte equality.
"""

import json

import numpy as np
import pytest
import torch

from eigen_zeth_tpu.models import stark as jstark
from eigen_zeth_tpu.ops import goldilocks as jgl
from eigen_zeth_tpu.ops import poseidon as jposeidon
from eigen_zeth_tpu_torch.models import stark, stark_batch
from eigen_zeth_tpu_torch.ops import goldilocks as gl
from eigen_zeth_tpu_torch.parallel import dryrun, mesh
from eigen_zeth_tpu_torch.protocol import prover_service as ps
from eigen_zeth_tpu_torch.utils.profiling import profile_trace

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker: the workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n_domain, n_chunk=1):
    return mesh.make_mesh(n_domain, n_chunk, devices=[CPU] * (n_domain * n_chunk))


PARAMS = dict(blowup=4, num_queries=2, terminal_size=16)


def test_prove_chunks_over_the_chunk_axis(monkeypatch):
    monkeypatch.setenv("EZT_FORCE_NP_STARK", "1")
    rng = np.random.default_rng(3)
    datas = [[int(x) for x in rng.integers(0, gl.P, 9 + k, dtype=np.uint64)] for k in range(3)]
    ivs = [int(x) for x in rng.integers(0, gl.P, 3, dtype=np.uint64)]
    serial = stark_batch.prove_chunks(datas, ivs, stark.StarkParams(**PARAMS), 16, device=CPU)
    meshed = stark_batch.prove_chunks(datas, ivs, stark.StarkParams(**PARAMS), 16,
                                      mesh=cpu_mesh(1, 2))
    want = [jstark.prove_chunk(d, iv, jstark.StarkParams(**PARAMS), n_rows=16)
            for d, iv in zip(datas, ivs)]
    assert json.dumps(meshed) == json.dumps(serial) == json.dumps(want)


def test_batch_prover_mesh_step_2():
    provers = [ps.BatchProver(stark_params=stark.StarkParams(**PARAMS), wrap="linear",
                              recursion=False, chunk_trace_rows=16, device=CPU, mesh=m)
               for m in (None, cpu_mesh(1, 2))]
    r1 = provers[0].gen_batch_chunks("t", list(range(1, 7)), 12345, "evm")
    assert r1.chunk_count >= 3
    steps = [p.gen_chunk_proof("t", r1.task_id, r1.chunk_count, 12345, "evm", r1.batch_data)
             for p in provers]
    assert [c.proof for c in steps[1].chunk_proofs] == [c.proof for c in steps[0].chunk_proofs]


def test_dryrun_entry_and_profile_trace(tmp_path, monkeypatch):
    out = dryrun.dryrun_multichip(4, devices=[CPU])
    assert out["mesh"] == (2, 2) and out["devices"] == ["cpu"] * 4 and out["ec_points"] == 8
    fn, (x,) = dryrun.entry(CPU)
    with profile_trace() as none:  # no directory: no trace
        assert none is None
    # one trace (the profiler's start costs seconds): into $EZT_PROFILE_DIR
    monkeypatch.setenv("EZT_PROFILE_DIR", str(tmp_path / "env"))
    with profile_trace() as path:
        root = fn(x)
    assert path.startswith(str(tmp_path / "env"))
    trace = json.loads(open(path).read())
    assert any(e.get("name") == "aten::index_select" for e in trace["traceEvents"])
    # the JAX package's host NTT, sponge and compression over the same column
    coeffs = gl.to_int(x)
    m = len(coeffs) * dryrun.ENTRY_BLOWUP
    shifted = jgl.np_mulmod(coeffs, jgl.powers_np(jgl.MULTIPLICATIVE_GENERATOR, len(coeffs)))
    evals = jgl.np_ntt(np.concatenate([shifted, np.zeros(m - len(coeffs), dtype=np.uint64)]))
    level = [jposeidon.hash_elements_host([int(v)]) for v in evals]
    while len(level) > 1:
        level = [jposeidon.hash_two_host(level[i], level[i + 1]) for i in range(0, len(level), 2)]
    assert [int(v) for v in gl.to_int(root)] == level[0]
