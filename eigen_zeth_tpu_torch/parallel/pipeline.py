"""Pipelined chunk proving beside host aggregation — port of
eigen_zeth_tpu/parallel/pipeline.py.

The reference's GenChunk -> GenChunkProof -> Aggregate -> Final state
machine (src/prover/provider.rs:276-540) runs its phases one after the
other.  `PipelinedBatchProver` overlaps two of them: a producer thread
proves the chunks one by one on the prover's device while host threads
aggregate each adjacent pair as soon as both of its proofs exist.  The
pairing is by index, so the result does not depend on completion order.

As in the JAX package, the producer cuts the batch every
CHUNK_FIELD_ELEMS elements and lets each chunk's trace size follow its
data, whatever the prover's own chunk shape.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from ..models import stark
from ..ops import poseidon
from ..protocol.messages import ProofResultCode
from ..protocol.prover_service import CHUNK_FIELD_ELEMS, BatchProver, bytes_to_field_elements


class PipelinedBatchProver:
    """Wraps BatchProver: proves chunks while aggregating finished ones."""

    def __init__(self, prover: BatchProver, agg_workers: int = 2):
        self.prover = prover
        self.agg_workers = agg_workers

    def prove_and_aggregate(
        self, batch_id: str, task_id: str, chunk_count: int,
        chain_id: int, program_name: str, batch_data: str,
    ) -> str:
        """Returns the final recursive (aggregated) proof string.

        Producer: sequential chunk proving on the device (one resource).
        Consumers: aggregation threads folding completed proofs pairwise
        in index order."""
        elems = bytes_to_field_elements(base64.b64decode(batch_data))
        done: queue.Queue = queue.Queue()

        def produce() -> None:
            try:
                for i in range(chunk_count):
                    chunk = elems[i * CHUNK_FIELD_ELEMS : (i + 1) * CHUNK_FIELD_ELEMS]
                    iv = poseidon.hash_elements_host([chain_id, int(task_id), i])[0]
                    proof = stark.prove_chunk(chunk, iv, self.prover.stark_params,
                                              device=self.prover.device)
                    done.put((i, json.dumps({"type": "chunk", "stark": proof})))
            except Exception as e:  # handed to the consumer, which raises it
                done.put((None, e))

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()

        # host consumers: aggregate adjacent pairs as soon as both exist
        proofs: List[Optional[str]] = [None] * chunk_count
        aggregated: List[Optional[str]] = [None] * ((chunk_count + 1) // 2)
        with ThreadPoolExecutor(max_workers=self.agg_workers) as pool:
            futures = []
            for _ in range(chunk_count):
                i, proof = done.get()
                if i is None:
                    raise proof
                proofs[i] = proof
                j = i ^ 1  # pair partner
                if j >= chunk_count:
                    aggregated[i // 2] = proof  # odd tail promotes directly
                elif proofs[j] is not None:
                    a, b = proofs[min(i, j)], proofs[max(i, j)]
                    futures.append(pool.submit(self._agg, batch_id, i // 2, a, b, aggregated))
            for f in futures:
                f.result()
        producer.join()

        level = list(aggregated)
        # fold the remaining tree levels on the host
        while len(level) > 1:
            nxt = []
            for k in range(0, len(level) - 1, 2):
                nxt.append(self._aggregate(batch_id, level[k], level[k + 1]))
            if len(level) % 2:
                nxt.append(level[-1])
            level = nxt
        if json.loads(level[0]).get("type") == "chunk":
            level = [self._aggregate(batch_id, level[0], level[0])]
        return level[0]

    def _aggregate(self, batch_id: str, a: str, b: str) -> str:
        res = self.prover.gen_aggregated_proof(batch_id, a, b)
        if res.result_code != ProofResultCode.COMPLETED_OK:
            raise RuntimeError(f"aggregation failed: {res.error_message}")
        return res.result_string

    def _agg(self, batch_id, slot, a, b, out):
        out[slot] = self._aggregate(batch_id, a, b)
