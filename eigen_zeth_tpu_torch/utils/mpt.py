"""Hexary Merkle-Patricia trie ROOT — Ethereum's state/storage/tx-root
commitment, computed functionally from a key/value map.

A copy of eigen_zeth_tpu/utils/mpt.py.  The reference computes the real
trie (src/custom_reth/mod.rs:714).  The sequencer's block state root, per-
account storage roots and the transactions root all come from here, with
Ethereum's exact construction:

  * secure trie: keys are keccak256(raw key) for state/storage
  * node encodings per the yellow paper: leaf/extension nodes are
    rlp([hex-prefix(path), value]); branch nodes are rlp([v0..v15, value])
  * nodes whose RLP is >= 32 bytes are referenced by keccak hash;
    shorter nodes embed inline
  * root = keccak256(rlp(root_node)); the empty trie root is
    keccak256(rlp(b'')) = 56e81f17...

Build-from-map (no incremental update): the sequencer recomputes roots
per block, which at dev-net account counts is microseconds and keeps the
code a pure function of the state."""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..ops import keccak
from . import rlp

EMPTY_ROOT = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421"
)


def _nibbles(key: bytes) -> List[int]:
    out = []
    for b in key:
        out.append(b >> 4)
        out.append(b & 0xF)
    return out


def _hex_prefix(nibbles: List[int], leaf: bool) -> bytes:
    """Yellow-paper hex-prefix encoding of a nibble path."""
    flag = 2 if leaf else 0
    if len(nibbles) % 2:
        data = [(flag + 1) << 4 | nibbles[0]]
        rest = nibbles[1:]
    else:
        data = [flag << 4]
        rest = nibbles
    for i in range(0, len(rest), 2):
        data.append(rest[i] << 4 | rest[i + 1])
    return bytes(data)


def _node_ref(encoded: bytes):
    """Nodes < 32 bytes embed inline (as the decoded structure would, but
    we only need the RLP: pass the raw bytes through a marker)."""
    if len(encoded) < 32:
        return _Raw(encoded)
    return keccak.keccak256_host(encoded)


class _Raw(bytes):
    """RLP-encoded node embedded inline (already encoded — emit as-is)."""


def _rlp(item) -> bytes:
    if isinstance(item, _Raw):
        return bytes(item)
    if isinstance(item, (list, tuple)):
        payload = b"".join(_rlp(x) for x in item)
        return rlp._len_prefix(len(payload), 0xC0) + payload
    return rlp.encode(item)


def _build(items: List[Tuple[List[int], bytes]]):
    """items: (nibble-path, value) pairs, all paths distinct, none a
    prefix of another (fixed-length keys guarantee this).  Returns the
    node reference (hash bytes or _Raw inline RLP)."""
    if not items:
        return b""
    if len(items) == 1:
        path, value = items[0]
        return _node_ref(_rlp([_hex_prefix(path, True), value]))
    # longest common prefix
    first = items[0][0]
    lcp = 0
    while all(len(p) > lcp and p[lcp] == first[lcp] for p, _ in items):
        lcp += 1
    if lcp:
        child = _build([(p[lcp:], v) for p, v in items])
        enc = _rlp([_hex_prefix(first[:lcp], False), _child_slot(child)])
        return _node_ref(enc)
    # branch on the first nibble
    slots: List[object] = [b""] * 17
    for nib in range(16):
        sub = [(p[1:], v) for p, v in items if p and p[0] == nib]
        if sub:
            slots[nib] = _child_slot(_build(sub))
    term = [v for p, v in items if not p]
    if term:
        slots[16] = term[0]
    return _node_ref(_rlp(slots))


def _child_slot(ref):
    """A child reference inside a parent node: hash -> 32-byte string;
    inline -> the raw RLP structure."""
    return ref  # _Raw passes through _rlp unchanged; bytes become strings


def trie_root(items: Dict[bytes, bytes]) -> bytes:
    """Root hash of the trie mapping key bytes -> value bytes."""
    if not items:
        return EMPTY_ROOT
    pairs = sorted((_nibbles(k), v) for k, v in items.items())
    ref = _build(pairs)
    if isinstance(ref, _Raw):
        return keccak.keccak256_host(bytes(ref))
    return ref


def secure_root(items: Dict[bytes, bytes]) -> bytes:
    """Secure trie root: keys are keccak256(raw key) — Ethereum's state
    and storage tries."""
    return trie_root({keccak.keccak256_host(k): v for k, v in items.items()})


def index_root(values: List[bytes]) -> bytes:
    """Trie keyed by rlp(index) — Ethereum's transactions/receipts root."""
    return trie_root({rlp.encode(i): v for i, v in enumerate(values)})
