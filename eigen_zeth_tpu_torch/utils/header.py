"""Canonical Ethereum block-header encoding and hashing.

block hash = keccak256(rlp(header)) over the consensus header field list
— the sealing the reference gets from reth's `header.seal_slow()`
(src/custom_reth/mod.rs:751-788), golden-vector tested against the
Ethereum mainnet genesis hash.  A copy of eigen_zeth_tpu/utils/header.py.

The field list grows with forks; encode_header includes the
post-London / post-Shanghai / post-Cancun tail fields exactly when the
block dict carries them:

  15 base fields (Frontier): parentHash, sha3Uncles, miner, stateRoot,
      transactionsRoot, receiptsRoot, logsBloom, difficulty, number,
      gasLimit, gasUsed, timestamp, extraData, mixHash, nonce
  +baseFeePerGas (EIP-1559), +withdrawalsRoot (EIP-4895),
  +blobGasUsed, +excessBlobGas (EIP-4844),
  +parentBeaconBlockRoot (EIP-4788)
"""

from __future__ import annotations

from ..ops import keccak
from . import rlp

# keccak256(rlp([])) — the ommers hash of every post-merge block
EMPTY_OMMERS_HASH = bytes.fromhex(
    "1dcc4de8dec75d7aab85b567b6ccd41ad312451b948a7413f0a142fd40d49347"
)


def _b(hexstr: str | None, width: int | None = None) -> bytes:
    """0x-hex -> bytes; zero-filled to `width` when given."""
    h = (hexstr or "0x")[2:]
    if width is not None:
        h = h.rjust(width * 2, "0")
    if len(h) % 2:
        h = "0" + h
    return bytes.fromhex(h)


def encode_header(block: dict) -> bytes:
    """Consensus RLP of a block-dict header (eth_getBlockByNumber keys)."""
    fields: list = [
        _b(block.get("parentHash"), 32),
        _b(block.get("sha3Uncles", "0x" + EMPTY_OMMERS_HASH.hex()), 32),
        _b(block.get("miner"), 20),
        _b(block.get("stateRoot"), 32),
        _b(block.get("transactionsRoot"), 32),
        _b(block.get("receiptsRoot"), 32),
        _b(block.get("logsBloom"), 256),
        rlp.tx_int(block.get("difficulty", "0x0")),
        rlp.tx_int(block.get("number", "0x0")),
        rlp.tx_int(block.get("gasLimit", "0x0")),
        rlp.tx_int(block.get("gasUsed", "0x0")),
        rlp.tx_int(block.get("timestamp", "0x0")),
        _b(block.get("extraData", "0x")),
        _b(block.get("mixHash", "0x"), 32),
        _b(block.get("nonce", "0x"), 8),
    ]
    if "baseFeePerGas" in block:
        fields.append(rlp.tx_int(block["baseFeePerGas"]))
        if "withdrawalsRoot" in block:
            fields.append(_b(block["withdrawalsRoot"], 32))
            if "blobGasUsed" in block:
                fields.append(rlp.tx_int(block["blobGasUsed"]))
                fields.append(rlp.tx_int(block.get("excessBlobGas", "0x0")))
                if "parentBeaconBlockRoot" in block:
                    fields.append(_b(block["parentBeaconBlockRoot"], 32))
    return rlp.encode(fields)


def block_hash(block: dict) -> str:
    """Canonical 0x-hex block hash: keccak256(rlp(header))."""
    return "0x" + keccak.keccak256_host(encode_header(block)).hex()
