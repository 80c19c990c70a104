"""Rollup pipeline KV store — copy of eigen_zeth_tpu/protocol/kv.py.

The reference's rollup state store (src/db/mod.rs:12-71): a 3-method byte
KV (get/put/del) through which the pipeline coordinates via well-known
keys, plus the block Status lifecycle Pending → Sequenced → Batching →
Submitted → Finalized.  The proving state machine keeps its step record
here.

Backends:
  * MemDb    — dict + lock (the reference's src/db/lfs/mem.rs analog)
  * FileDb   — append-only log + in-memory index, durable across restarts
               (the libmdbx analog, src/db/lfs/libmdbx.rs); pure python
  * NativeDb — the same log format served by the C++ engine in
               native/zethdb.cpp through ctypes (`open_db("native")`); a
               failed build or load raises, nothing falls back to FileDb
"""

from __future__ import annotations

import json
import os
import struct
import threading
from dataclasses import dataclass
from enum import Enum
from typing import Dict, Optional

# --- well-known keys (reference: src/db/mod.rs:32-41) ----------------------
KEY_LAST_SEQUENCE_FINALITY_BLOCK_NUMBER = b"LAST_SEQUENCE_FINALITY_BLOCK_NUMBER"
KEY_NEXT_BATCH = b"NEXT_BATCH"
KEY_LAST_SUBMITTED_BLOCK_NUMBER = b"LAST_SUBMITTED_BLOCK_NUMBER"
KEY_LAST_PROVEN_BLOCK_NUMBER = b"LAST_PROVEN_BLOCK_NUMBER"
KEY_LAST_VERIFIED_BLOCK_NUMBER = b"LAST_VERIFIED_BLOCK_NUMBER"
KEY_PROVE_STEP_RECORD = b"PROVE_STEP_RECORD"
KEY_LAST_VERIFIED_BATCH_NUMBER = b"LAST_VERIFIED_BATCH_NUMBER"

# --- prefixes (reference: src/db/mod.rs:43-46) -----------------------------
PREFIX_BATCH_PROOF = b"BATCH_PROOF_"
PREFIX_BLOCK_STATUS = b"BLOCK_STATUS_"


class Status(str, Enum):
    """Block lifecycle (reference: src/db/mod.rs:48-61)."""

    Pending = "Pending"
    Sequenced = "Sequenced"
    Batching = "Batching"
    Submitted = "Submitted"
    Finalized = "Finalized"


@dataclass
class ProofResult:
    """Reference: src/db/mod.rs:63-71 (stored under BATCH_PROOF_{n})."""

    block_number: int
    proof: str
    public_input: str
    pre_state_root: bytes = b"\x00" * 32
    post_state_root: bytes = b"\x00" * 32

    def to_json(self) -> str:
        return json.dumps(
            {
                "block_number": self.block_number,
                "proof": self.proof,
                "public_input": self.public_input,
                "pre_state_root": list(self.pre_state_root),
                "post_state_root": list(self.post_state_root),
            }
        )

    @classmethod
    def from_json(cls, raw: str) -> "ProofResult":
        d = json.loads(raw)
        return cls(
            block_number=int(d["block_number"]),
            proof=d["proof"],
            public_input=d["public_input"],
            pre_state_root=bytes(d["pre_state_root"]),
            post_state_root=bytes(d["post_state_root"]),
        )


class Database:
    """The 3-method trait (reference: src/db/mod.rs:12-16)."""

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    # -- typed helpers shared by all backends -------------------------------

    def get_u64(self, key: bytes) -> Optional[int]:
        v = self.get(key)
        return int(v.decode()) if v is not None else None

    def put_u64(self, key: bytes, value: int) -> None:
        self.put(key, str(int(value)).encode())

    def get_status(self, block: int) -> Optional[Status]:
        v = self.get(PREFIX_BLOCK_STATUS + str(block).encode())
        return Status(v.decode()) if v is not None else None

    def put_status(self, block: int, status: Status) -> None:
        self.put(PREFIX_BLOCK_STATUS + str(block).encode(), status.value.encode())

    def get_proof(self, block: int) -> Optional[ProofResult]:
        v = self.get(PREFIX_BATCH_PROOF + str(block).encode())
        return ProofResult.from_json(v.decode()) if v is not None else None

    def put_proof(self, block: int, proof: ProofResult) -> None:
        self.put(PREFIX_BATCH_PROOF + str(block).encode(), proof.to_json().encode())


class MemDb(Database):
    """RwLock<HashMap> analog (reference: src/db/lfs/mem.rs:7-29)."""

    def __init__(self):
        self._d: Dict[bytes, bytes] = {}
        self._lock = threading.Lock()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._d.get(bytes(key))

    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._d[bytes(key)] = bytes(value)

    def delete(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._d.pop(bytes(key), None)


_MAGIC = b"EZTL"  # log record: magic u32len(key) u32len(val|0xFFFFFFFF=del) key val


class FileDb(Database):
    """Append-only log + in-memory index; crash-durable, compacting.

    Record: MAGIC | u32 klen | u32 vlen (0xFFFFFFFF = tombstone) | k | v.
    The whole log replays on open (the libmdbx-role store holds small
    pipeline state: counters, step records, proofs)."""

    DELETE = 0xFFFFFFFF

    def __init__(self, path: str):
        self._path = path
        self._lock = threading.Lock()
        self._d: Dict[bytes, bytes] = {}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.exists(path):
            self._replay()
        self._f = open(path, "ab")

    def _replay(self):
        with open(self._path, "rb") as f:
            data = f.read()
        off = 0
        while off + 12 <= len(data):
            if data[off : off + 4] != _MAGIC:
                break  # torn tail
            klen, vlen = struct.unpack_from("<II", data, off + 4)
            off += 12
            if off + klen > len(data):
                break
            key = data[off : off + klen]
            off += klen
            if vlen == self.DELETE:
                self._d.pop(key, None)
                continue
            if off + vlen > len(data):
                break
            self._d[key] = data[off : off + vlen]
            off += vlen

    def _append(self, key: bytes, value: Optional[bytes]):
        vlen = self.DELETE if value is None else len(value)
        rec = _MAGIC + struct.pack("<II", len(key), vlen) + key
        if value is not None:
            rec += value
        self._f.write(rec)
        self._f.flush()
        os.fsync(self._f.fileno())

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._d.get(bytes(key))

    def put(self, key: bytes, value: bytes) -> None:
        key, value = bytes(key), bytes(value)
        with self._lock:
            self._d[key] = value
            self._append(key, value)

    def delete(self, key: bytes) -> Optional[bytes]:
        key = bytes(key)
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self._append(key, None)
            return old

    def close(self):
        self._f.close()


def open_db(kind: str = "memory", path: str | None = None) -> Database:
    """Factory (reference: src/db/lfs/mod.rs:14-19 — 'mdbx' | 'memory')."""
    if kind == "memory":
        return MemDb()
    if kind in ("file", "mdbx", "native"):
        if not path:
            raise ValueError("file-backed database needs a path")
        if kind == "native":
            from ..native.zethdb import NativeDb

            return NativeDb(path)
        return FileDb(path)
    raise ValueError(f"unknown database kind {kind!r}")
