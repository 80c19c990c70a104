"""On the card, at the node's wrap profile (the configuration
stark-wrap-2leaf-grpc): the plain reference's constants root equals the one
the configuration pins and the program's; an attestation the program makes
on the card is accepted by the plain verifier.  Skipped without a CUDA
device."""

import dataclasses
import json

import pytest

from zkbench import harness
from zkbench import traffic as traffic_m
from zkbench.reference import air_wrap

CELL = "attest-wrap.stark-wrap-2leaf-grpc.wrap-pair"


def _device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the node's wrap shape runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_constants_root_is_pinned():
    from eigen_zeth_tpu_torch.models import air_wrap as program_air_wrap
    from eigen_zeth_tpu_torch.models import recursion

    dev = _device()
    pins = air_wrap.Pins.of(harness.load_cell(CELL)["config"])
    plain = air_wrap.constants_root(pins.air(), dev)
    air = recursion.attestation_air(pins.chunk_rows, pins.chunk_queries, pins.terminal)[0]
    air = dataclasses.replace(air, ext_blowup=pins.wrap_blowup)
    assert plain == pins.const_root == program_air_wrap.constants_root(air, air_wrap.SHIFT, dev)


@pytest.mark.gpu
def test_card_attestation_is_accepted():
    from eigen_zeth_tpu_torch.models import recursion

    dev = _device()
    cell = harness.load_cell(CELL)
    config = cell["config"]
    prover = harness.make_prover(config, dev)
    req = traffic_m.request((1 << 31) + 29, 0, cell["traffic"], config)
    kids = prover.gen_chunk_proof(req.batch_id, req.task_id, req.chunk_count, config["chain_id"],
                                  config["program_name"], req.batch_data)
    child = json.loads(kids.chunk_proofs[1].proof)["stark"]
    p = config["prover"]
    att = recursion.attest_chunk_wrap(child, num_queries_wrap=p["wrap_queries"],
                                      grind_bits=p["wrap_grind_bits"],
                                      ext_blowup=p["wrap_blowup"], device=dev)
    pins = air_wrap.Pins.of(config)
    assert air_wrap.verify_many([att], pins, dev) == ["accepted"]
