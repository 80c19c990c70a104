"""The two service steps that the cells drive, worked out again from the
inputs the harness hands the program: step 2 (a chunk proof per chunk of a
batch payload) and step 3 (two chunk children attested and their digests
chained).  The strings are those the prover service returns, byte for byte.
"""

from __future__ import annotations

import base64
import json
from typing import List

from . import poseidon, recursion, stark


def bytes_to_field_elements(data: bytes) -> List[int]:
    """7 bytes per Goldilocks element (2^56 < p), little-endian."""
    return [int.from_bytes(data[off : off + 7], "little") for off in range(0, len(data), 7)]


def chunk_digest(proof: dict) -> List[int]:
    """A chunk proof's digest: its public values and trace root, hashed."""
    vals = [
        int(proof["n"]),
        int(proof["public"]["iv"]),
        int(proof["public"]["out"]),
        int(proof["public"]["gamma"]),
    ] + [int(x) for x in proof["trace_root"]]
    return poseidon.hash_elements_host(vals)


def chunk_proofs(batch_data: str, task_id: str, chunk_count: int, chain_id: int,
                 params: stark.StarkParams, rows: int, chunk_elems: int, *,
                 device) -> List[dict]:
    """Step 2: [{"chunk_id", "proof_key", "proof"}] for every chunk of the
    base64 payload; the chunk i's iv hashes (chain id, task id, i)."""
    elems = bytes_to_field_elements(base64.b64decode(batch_data))
    chunks = [elems[i * chunk_elems : (i + 1) * chunk_elems] for i in range(chunk_count)]
    ivs = [poseidon.hash_elements_host([chain_id, int(task_id), i])[0]
           for i in range(chunk_count)]
    proofs = stark.prove_chunks(chunks, ivs, params, n=rows, device=device)
    return [
        {"chunk_id": i, "proof_key": f"{task_id}/{i}",
         "proof": json.dumps({"type": "chunk", "stark": proof})}
        for i, proof in enumerate(proofs)
    ]


def aggregate(proof_1: str, proof_2: str, agg_queries: int, *, device,
              attest=(0, 1)) -> dict:
    """Step 3 with recursion on: each chunk child attested by the verifier
    AIR, the two chunk digests chained; the aggregated proof as the dict
    whose JSON the service returns.  Only the children whose positions are
    in `attest` are proved; the others get their header and query count
    (all the digest needs) and "air_proof" None."""
    kids, digests = [], []
    for k, raw in enumerate((proof_1, proof_2)):
        node = json.loads(raw)
        if node.get("type") != "chunk":
            raise ValueError(f"expected a chunk child, got {node.get('type')!r}")
        child = node["stark"]
        if k in attest:
            att = recursion.attest_chunk(child, num_queries_agg=agg_queries, device=device)
        else:
            att = {"type": "chunk-attested", "q_c": len(child["fri"]["queries"]),
                   "header": recursion.child_header(child), "air_proof": None}
        digests.append(chunk_digest(att["header"]))
        kids.append(att)
    digest = poseidon.hash_two_host(*digests)
    return {"type": "aggregated", "digest": [str(x) for x in digest], "children": kids}
