"""The port's chain executor against the JAX package's.

`ChainExecutor` reads the batch's blocks from the L2 and packs
pre_state_root || post_state_root || RLP(tx)... with the rollup worker's
legacy-transaction packing (`utils/rlp.encode_legacy_tx`), which the chunk
STARKs commit to.  Each case feeds the JAX package's executor and the
port's the same chain (a dict of blocks, or chip_smoke.py's stand-in L2
over loopback JSON-RPC) and holds the port's ExecutionResult, and its
step-1 result, to the JAX one.  Tolerance: none, bytes must be identical.
"""

import dataclasses

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from eigen_zeth_tpu.models import stark as jstark
from eigen_zeth_tpu.protocol import prover_service as jps
from eigen_zeth_tpu.settlement.ethereum import JsonRpcClient as JJsonRpcClient
from eigen_zeth_tpu.utils import rlp as jrlp
from eigen_zeth_tpu_torch.models import stark
from eigen_zeth_tpu_torch.protocol import prover_service as ps
from eigen_zeth_tpu_torch.protocol.messages import ProofResultCode
from eigen_zeth_tpu_torch.settlement.ethereum import JsonRpcClient
from eigen_zeth_tpu_torch.utils import rlp

CPU = torch.device("cpu")
SP = dict(blowup=4, num_queries=2, terminal_size=16)

_uint = st.integers(min_value=0, max_value=(1 << 256) - 1)
_hex = _uint.map(hex)
_field = st.one_of(st.none(), _hex, _uint, st.integers(0, 1 << 64).map(str))
TX = st.fixed_dictionaries(
    {
        "nonce": _field, "gasPrice": _field, "gas": _field, "value": _field,
        "v": _field, "r": _field, "s": _field,
        # contract creation (no `to`, or an empty one) among the calls
        "to": st.one_of(st.none(), st.just(""), st.binary(min_size=20, max_size=20).map(
            lambda b: "0x" + b.hex())),
        # empty, short, and calldata past the 56-byte and 64 KiB length forms
        "input": st.one_of(st.just("0x"), st.binary(max_size=200),
                           st.binary(min_size=65_536, max_size=70_000)).map(
            lambda b: b if isinstance(b, str) else "0x" + b.hex()),
    },
    optional={"chainId": _hex},
)


@settings(max_examples=60, deadline=None)
@given(tx=TX, chain_id=st.integers(1, 1 << 40))
def test_encode_legacy_tx_equals_jax(tx, chain_id):
    tx = {k: v for k, v in tx.items() if v is not None or k == "to"}
    assert rlp.encode_legacy_tx(tx, chain_id) == jrlp.encode_legacy_tx(tx, chain_id)


@settings(max_examples=60, deadline=None)
@given(item=st.recursive(
    st.one_of(st.binary(max_size=80), st.integers(0, 1 << 300)),
    lambda kids: st.lists(kids, max_size=6), max_leaves=20))
def test_rlp_encode_equals_jax(item):
    assert rlp.encode(item) == jrlp.encode(item)


class DictChain:
    """A chain of blocks held in a dict, with the sequencer's interface."""

    def __init__(self, blocks):
        self.blocks = blocks

    def get_block_by_number(self, n, full_txs=False):
        return self.blocks.get(n)


def _blocks():
    blocks = chip_smoke.l2_blocks(7)
    parent, block = blocks[chip_smoke.L2_BLOCK - 1], blocks[chip_smoke.L2_BLOCK]
    # a second block without a stateRoot (the content commitment) and with
    # a contract creation
    creation = dict(block["transactions"][0], to=None, input="0x" + "60" * 300)
    nxt = {"number": hex(chip_smoke.L2_BLOCK + 1), "transactions": [creation]}
    return {chip_smoke.L2_BLOCK - 1: parent, chip_smoke.L2_BLOCK: block,
            chip_smoke.L2_BLOCK + 1: nxt}


def _provers(chain, jchain):
    kw = dict(wrap="linear", recursion=False, chunk_trace_rows=16)
    jprover = jps.BatchProver(executor=jps.ChainExecutor(jchain), use_jit=False,
                              stark_params=jstark.StarkParams(**SP), **kw)
    prover = ps.BatchProver(executor=ps.ChainExecutor(chain), device=CPU,
                            stark_params=stark.StarkParams(**SP), **kw)
    return jprover, prover


def _same(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("numbers", [[1], [2], [2, 1]])
def test_chain_executor_equals_jax_on_a_dict_chain(numbers):
    chain = DictChain(_blocks())
    _same(ps.ChainExecutor(chain).execute(numbers, 12345),
          jps.ChainExecutor(chain).execute(numbers, 12345))
    jprover, prover = _provers(chain, chain)
    got, want = (p.gen_batch_chunks("b", numbers, 12345, "evm") for p in (prover, jprover))
    assert got.result_code == ProofResultCode.COMPLETED_OK
    _same(got, want)


def test_chain_executor_over_json_rpc_equals_jax():
    """Both executors read chip_smoke.py's stand-in L2 over loopback
    JSON-RPC, each through its own package's client; the batch is the
    phase's: 2 chunks of the production chunk size."""
    blocks = chip_smoke.l2_blocks(chip_smoke.L2_SEED)
    with chip_smoke.StandInL2(blocks) as l2:
        ex = ps.ChainExecutor(JsonRpcClient(l2.url)).execute([chip_smoke.L2_BLOCK],
                                                              chip_smoke.CHAIN_ID)
        jex = jps.ChainExecutor(JJsonRpcClient(l2.url)).execute([chip_smoke.L2_BLOCK],
                                                                chip_smoke.CHAIN_ID)
        jprover, prover = _provers(JsonRpcClient(l2.url), JJsonRpcClient(l2.url))
        got, want = (p.gen_batch_chunks("b", [1], 12345, "evm") for p in (prover, jprover))
    _same(ex, jex)
    _same(got, want)
    assert ex.pre_state_root == bytes.fromhex(blocks[0]["stateRoot"][2:])
    assert ex.post_state_root == bytes.fromhex(blocks[1]["stateRoot"][2:])
    elems = -(-len(ex.batch_data) // 7)
    assert -(-elems // ps.CHUNK_FIELD_ELEMS) == 2


@pytest.mark.parametrize("numbers", [[1], [2, 3], []], ids=["no-parent", "no-block", "empty"])
def test_missing_blocks_give_the_jax_completed_error(numbers):
    chain = DictChain(_blocks())
    if numbers == [1]:
        del chain.blocks[0]
    jprover, prover = _provers(chain, chain)
    got, want = (p.gen_batch_chunks("b", numbers, 12345, "evm") for p in (prover, jprover))
    assert want.result_code == ProofResultCode.COMPLETED_ERROR
    _same(got, want)
