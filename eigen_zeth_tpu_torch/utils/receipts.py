"""Ethereum receipt encoding: logs bloom + receipts-trie root.

Reference analog: the payload builder assembles per-tx receipts and the
header's receipts_root / logs_bloom when sealing a block
(src/custom_reth/mod.rs:687-788 — reth's calculate_receipt_root +
Bloom aggregation).  Same canonical encoding, built on utils/rlp +
utils/mpt:

  receipt rlp = rlp([status, cumulative_gas_used, bloom_256B,
                     [[address, [topic...], data], ...]])
  receipts_root = index-keyed MPT root over the encoded receipts
  bloom: each log address and topic sets 3 of 2048 bits, chosen from
  byte pairs 0-1, 2-3, 4-5 of its keccak256 (yellow-paper M3:2048)

A copy of eigen_zeth_tpu/utils/receipts.py.
"""

from __future__ import annotations

from typing import Dict, List

from ..ops import keccak
from . import mpt, rlp

BLOOM_BYTES = 256  # 2048 bits


def _hx(s: str) -> bytes:
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


def bloom_add(bloom: bytearray, item: bytes) -> None:
    """Set the 3 bloom bits for one item (address or topic)."""
    h = keccak.keccak256_host(item)
    for i in (0, 2, 4):
        bit = ((h[i] << 8) | h[i + 1]) & 2047
        # bit 0 is the LOW-order bit of the LAST byte (big-endian bitfield)
        bloom[BLOOM_BYTES - 1 - bit // 8] |= 1 << (bit % 8)


def logs_bloom(logs: List[Dict]) -> bytes:
    """Bloom over a list of log dicts ({address, topics[], data} hex)."""
    b = bytearray(BLOOM_BYTES)
    for log in logs:
        bloom_add(b, _hx(log["address"]))
        for t in log["topics"]:
            bloom_add(b, _hx(t))
    return bytes(b)


def encode_receipt(status: int, cumulative_gas: int, logs: List[Dict]) -> bytes:
    enc_logs = [
        [_hx(l["address"]), [_hx(t) for t in l["topics"]], _hx(l["data"])]
        for l in logs
    ]
    return rlp.encode([status, cumulative_gas, logs_bloom(logs), enc_logs])


def receipts_root(receipts: List[Dict]) -> bytes:
    """Index-keyed receipts-trie root; receipts carry status/gasUsed ints
    and the RPC-shaped logs list."""
    cumulative = 0
    encoded = []
    for r in receipts:
        cumulative += int(r.get("gasUsed", 0) or 0)
        encoded.append(
            encode_receipt(int(r.get("status", 0)), cumulative, r.get("logs", []))
        )
    return mpt.index_root(encoded)


def bloom_contains(bloom, item: bytes) -> bool:
    """May-contain check (no false negatives) — the eth_getLogs
    prefilter role."""
    as_int = int.from_bytes(bloom, "big") if isinstance(bloom, bytes) else int(bloom)
    h = keccak.keccak256_host(item)
    return all(
        (as_int >> (((h[i] << 8) | h[i + 1]) & 2047)) & 1 for i in (0, 2, 4)
    )


def block_bloom(receipts: List[Dict]) -> bytes:
    """Header logsBloom = OR of the per-receipt blooms."""
    b = bytearray(BLOOM_BYTES)
    for r in receipts:
        for log in r.get("logs", []):
            bloom_add(b, _hx(log["address"]))
            for t in log["topics"]:
                bloom_add(b, _hx(t))
    return bytes(b)
