"""The plain reference equals the program byte for byte on the CPU at a
small chunk shape: step 2's chunk proofs and step 3's aggregated proof
(both attestations and the chained digest), on two full chunks and on a
full chunk and a partial one."""

import base64
import json

import numpy as np
import pytest
import torch

from zkbench.reference import service
from zkbench.reference import stark as ref_stark

ROWS, QUERIES, TERMINAL, AGG_QUERIES = 8, 2, 32, 8


@pytest.mark.parametrize("fill", [2.0, 1.5], ids=["full", "partial"])
def test_reference_equals_the_program(fill):
    from eigen_zeth_tpu_torch.models import stark
    from eigen_zeth_tpu_torch.protocol import prover_service as ps

    prover = ps.BatchProver(recursion=True, wrap="mimc", chunk_trace_rows=ROWS,
                            stark_params=stark.StarkParams(4, QUERIES, TERMINAL),
                            agg_queries=AGG_QUERIES, device=torch.device("cpu"))
    payload = np.random.default_rng(11).bytes(int(7 * prover.chunk_elems * fill))
    b64 = base64.b64encode(payload).decode()
    r = prover.gen_chunk_proof("b", "1234567", 2, 12345, "evm", b64)
    ref = service.chunk_proofs(b64, "1234567", 2, 12345,
                               ref_stark.StarkParams(4, QUERIES, TERMINAL), ROWS,
                               prover.chunk_elems, device="cpu")
    assert [(c.chunk_id, c.proof_key, c.proof) for c in r.chunk_proofs] == \
        [(k["chunk_id"], k["proof_key"], k["proof"]) for k in ref]
    a = prover.gen_aggregated_proof("b", r.chunk_proofs[0].proof, r.chunk_proofs[1].proof)
    assert a.result_code == 0
    assert a.result_string == json.dumps(service.aggregate(ref[0]["proof"], ref[1]["proof"],
                                                           AGG_QUERIES, device="cpu"))


def test_bytes_to_field_elements():
    data = bytes(range(1, 16))
    assert service.bytes_to_field_elements(data) == [
        int.from_bytes(data[0:7], "little"), int.from_bytes(data[7:14], "little"), 15]
