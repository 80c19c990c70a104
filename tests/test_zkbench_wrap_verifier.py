"""The benchmark's plain wrap-attestation verifier (zkbench/reference/
air_wrap.py) on the port's attestations, at the small shape of
tests/zkbench_wrap_small.py (8-row chunks, 2 wrap queries, 4 grinding bits,
blowup 8).

The port's step 3 on request 0's children, in process, gives the answers
that a run of the cell reads: the envelope equals the reference's, worked out
from the request's inputs, byte for byte, and both attestations are
accepted.  The verifier rejects an attestation with an opened value changed,
a path's sibling changed, another grinding nonce, one wrap query fewer than
pinned (the port's own attestation at 1 query), one grinding bit fewer
declared, and another trace size in the child's header; the other
attestation of the batch stays accepted."""

import copy
import json

import pytest
import torch
import zkbench_wrap_small as small

from zkbench import harness
from zkbench import traffic as traffic_m
from zkbench.entries import aggregate_wrap
from zkbench.reference import air_wrap

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundle():
    """(cell, request 0, the port's aggregated proof of its children)."""
    mp = pytest.MonkeyPatch()
    small.use_store(mp)
    try:
        cell = small.small_cell()
        config = cell["config"]
        prover = harness.make_prover(config, CPU)
        req = traffic_m.request(small.SEED, 0, cell["traffic"], config)
        kids = prover.gen_chunk_proof(req.batch_id, req.task_id, req.chunk_count,
                                      config["chain_id"], config["program_name"], req.batch_data)
        out = prover.gen_aggregated_proof(req.batch_id, kids.chunk_proofs[0].proof,
                                          kids.chunk_proofs[1].proof)
        assert out.result_code == 0, out.error_message
        return cell, req, out.result_string
    finally:
        mp.undo()


def test_answers_equal_the_reference(bundle):
    cell, req, result = bundle
    pins = air_wrap.Pins.of(cell["config"])
    got = aggregate_wrap.answers(result, pins, CPU)
    want = aggregate_wrap.expected(req, cell["config"], CPU)
    assert got[1:] == ["accepted", "accepted"]
    assert got[0] == want[0]
    assert json.loads(got[0])["canonical"] is True


def _att(bundle, k=0):
    return copy.deepcopy(json.loads(bundle[2])["children"][k])


def _value(att):
    row = att["wrap_proof"]["trace_openings"][0][1]["row"]
    row[5] = str((int(row[5]) + 1) % 0xFFFFFFFF00000001)


def _sibling(att):
    path = att["wrap_proof"]["trace_openings"][1][2]["path"]
    path[3] = str(int(path[3]) + 1)


def _nonce(att):
    fri = att["wrap_proof"]["fri"]
    fri["grind_nonce"] = str(int(fri["grind_nonce"]) + 1)


def _grind_bits(att):
    att["wrap_proof"]["grind_bits"] -= 1


def _header_n(att):
    att["header"]["n"] = att["header"]["n"] * 2


TAMPERS = {"opened-value": _value, "path-sibling": _sibling, "nonce": _nonce,
           "grind-bits": _grind_bits, "header-n": _header_n}


@pytest.fixture(scope="module")
def tampered(bundle):
    """The verdicts of each tampered copy of the first attestation, and of
    the second as it is, in one batch."""
    pins = air_wrap.Pins.of(bundle[0]["config"])
    bad = []
    for name in sorted(TAMPERS):
        att = _att(bundle, 0)
        TAMPERS[name](att)
        bad.append(att)
    verdicts = air_wrap.verify_many(bad + [_att(bundle, 1)], pins, CPU)
    return dict(zip(sorted(TAMPERS), verdicts)), verdicts[-1]


@pytest.mark.parametrize("tamper", sorted(TAMPERS))
def test_tampered_attestation_is_rejected(tampered, tamper):
    verdicts, untouched = tampered
    assert verdicts[tamper].startswith("rejected: "), verdicts
    assert untouched == "accepted"


def test_one_wrap_query_fewer_is_rejected(bundle):
    """The port's own attestation of the same child at one wrap query fewer
    than the pins: a sound proof of a weaker statement."""
    cell = bundle[0]
    att = _att(bundle, 0)
    p = small.PROVER
    child = small.children(cell, 0)[0]
    weaker = json.loads(small.store()["attestations"][small.key(
        child, p["wrap_queries"] - 1, p["wrap_grind_bits"], p["wrap_blowup"])])
    assert weaker["header"] == att["header"] and weaker["wrap_proof"]["num_queries"] == 1
    pins = air_wrap.Pins.of(cell["config"])
    assert air_wrap.verify_many([weaker], pins, CPU)[0] == "rejected: wrap queries 1, pinned 2"
    loose = air_wrap.Pins(**dict(pins.__dict__, wrap_queries=1))
    assert air_wrap.verify_many([weaker], loose, CPU) == ["accepted"]


def test_constants_root_is_pinned(bundle):
    """Another constants root than the pinned one is refused."""
    cell = bundle[0]
    pins = air_wrap.Pins.of(cell["config"])
    other = air_wrap.Pins(**dict(pins.__dict__, const_root=pins.const_root + 1))
    assert air_wrap.verify_many([_att(bundle, 0)], other, CPU) == [
        "rejected: constants root differs from the pinned one"]


@pytest.mark.slow
def test_store_is_the_ports_attestation():
    """The store's attestation of request 0's first child is what the
    port's `attest_chunk_wrap` makes of it now (some 3 minutes on the CPU)."""
    from eigen_zeth_tpu_torch.models import recursion

    p = small.PROVER
    child = small.children(small.small_cell(), 0)[0]
    att = recursion.attest_chunk_wrap(child, num_queries_wrap=p["wrap_queries"],
                                      grind_bits=p["wrap_grind_bits"],
                                      ext_blowup=p["wrap_blowup"], device=CPU)
    held = small.store()["attestations"]
    assert json.dumps(att) == held[small.key(child, p["wrap_queries"], p["wrap_grind_bits"],
                                             p["wrap_blowup"])]
