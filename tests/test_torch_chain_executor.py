"""The port's chain executor against the JAX package's.

`ChainExecutor` reads the batch's blocks from the L2 and packs
pre_state_root || post_state_root || RLP(tx)... with the rollup worker's
legacy-transaction packing (`utils/rlp.encode_legacy_tx`), which the chunk
STARKs commit to.  Each case feeds the JAX package's executor and the
port's the same chain (a dict of blocks from the port's sequencer, or the
port's node serving chip_smoke.py's block over loopback JSON-RPC) and holds
the port's ExecutionResult, and its step-1 result, to the JAX one.
Tolerance: none, bytes must be identical.
"""

import dataclasses
import functools

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
from eigen_zeth_tpu_torch.protocol import kv, rpc
from eigen_zeth_tpu_torch.protocol.messages import ProofResultCode
from eigen_zeth_tpu_torch.sequencer.chain import Sequencer
from eigen_zeth_tpu_torch.settlement.ethereum import JsonRpcClient
from eigen_zeth_tpu_torch.utils import rlp, secp256k1

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


@functools.lru_cache(maxsize=None)
def node_chain(seed: int, n: int) -> Sequencer:
    """The port's sequencer holding block L2_BLOCK: n transactions of
    chip_smoke.py's mix from seed, signed as chip_smoke.py signs them."""
    jobs = chip_smoke.l2_transactions(seed, n)
    raws = [chip_smoke.sign_raw(job) for job in jobs]
    senders = {key: secp256k1.priv_to_address(key).lower() for _, key in jobs}
    seq = Sequencer(chain_id=chip_smoke.CHAIN_ID, auto_fund=True)
    for raw, (_, key) in zip(raws, jobs):
        nonce, price, gas, to, value, data, v, r, s = (
            rlp.decode_int(x) if k not in (3, 5) else x for k, x in enumerate(rlp.decode(raw)))
        seq.send_raw_transaction({
            "from": senders[key], "nonce": hex(nonce), "gasPrice": hex(price), "gas": hex(gas),
            "to": "0x" + to.hex(), "value": hex(value), "input": "0x" + data.hex(),
            "v": hex(v), "r": hex(r), "s": hex(s)})
    seq.build_block(timestamp=1_760_000_002)
    assert seq.block_number() == chip_smoke.L2_BLOCK
    return seq


def _blocks():
    """chip_smoke.py's phase 10 block (168 transactions, 2 chunks of the
    production size) and its parent, as the port's sequencer sealed them."""
    seq = node_chain(chip_smoke.L2_SEED, chip_smoke.L2_TXS)
    parent, block = (seq.get_block_by_number(n, True)
                     for n in (chip_smoke.L2_BLOCK - 1, chip_smoke.L2_BLOCK))
    # a second block without a stateRoot (the content commitment) and with
    # a contract creation at a nonce of two bytes
    creation = dict(block["transactions"][0], to=None, nonce=hex(5000),
                    input="0x" + "60" * 300)
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


def _production_chunks(ex) -> int:
    """Chunks of the batch's payload at the production chunk size (7 bytes
    an element)."""
    return -(-(-(-len(ex.batch_data) // 7)) // ps.CHUNK_FIELD_ELEMS)


def _same(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("numbers", [[1], [2], [2, 1]])
def test_chain_executor_equals_jax_on_a_dict_chain(numbers):
    chain = DictChain(_blocks())
    ex = ps.ChainExecutor(chain).execute(numbers, 12345)
    _same(ex, jps.ChainExecutor(chain).execute(numbers, 12345))
    if numbers == [1]:  # the batch crosses a chunk boundary of the production size
        assert _production_chunks(ex) == 2
    jprover, prover = _provers(chain, chain)
    got, want = (p.gen_batch_chunks("b", numbers, 12345, "evm") for p in (prover, jprover))
    assert got.result_code == ProofResultCode.COMPLETED_OK
    _same(got, want)


def test_chain_executor_over_json_rpc_equals_jax():
    """Both executors read the port's node (its eigenrpc server) over
    loopback JSON-RPC, each through its own package's client; the batch is
    chip_smoke.py's phase 10 block: 2 chunks of the production chunk size."""
    seq = node_chain(chip_smoke.L2_SEED, chip_smoke.L2_TXS)
    server = rpc.EigenRpcServer(kv.MemDb(), seq).start()
    url = f"http://127.0.0.1:{server.port}"
    try:
        ex = ps.ChainExecutor(JsonRpcClient(url)).execute([chip_smoke.L2_BLOCK],
                                                          chip_smoke.CHAIN_ID)
        jex = jps.ChainExecutor(JJsonRpcClient(url)).execute([chip_smoke.L2_BLOCK],
                                                             chip_smoke.CHAIN_ID)
        jprover, prover = _provers(JsonRpcClient(url), JJsonRpcClient(url))
        got, want = (p.gen_batch_chunks("b", [1], 12345, "evm") for p in (prover, jprover))
    finally:
        server.stop()
    _same(ex, jex)
    _same(got, want)
    assert ex.pre_state_root == bytes.fromhex(seq.get_block_by_number(0)["stateRoot"][2:])
    assert ex.post_state_root == bytes.fromhex(seq.get_block_by_number(1)["stateRoot"][2:])
    assert len(seq.get_block_by_number(1)["transactions"]) == chip_smoke.L2_TXS
    assert _production_chunks(ex) == 2


@pytest.mark.parametrize("numbers", [[1], [2, 3], []], ids=["no-parent", "no-block", "empty"])
def test_missing_blocks_give_the_jax_completed_error(numbers):
    chain = DictChain(_blocks())
    if numbers == [1]:
        del chain.blocks[0]
    jprover, prover = _provers(chain, chain)
    got, want = (p.gen_batch_chunks("b", numbers, 12345, "evm") for p in (prover, jprover))
    assert want.result_code == ProofResultCode.COMPLETED_ERROR
    _same(got, want)
