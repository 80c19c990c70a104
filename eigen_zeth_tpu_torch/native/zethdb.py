"""ctypes binding for the native zethdb engine — port of
eigen_zeth_tpu/native/zethdb.py over the port's own copy of zethdb.cpp.

g++ builds the shared library at first use into
`eigen_zeth_tpu_torch/_build/zethdb-<hash of the source>/`; NativeDb then
implements the same Database trait as the python backends over the
identical on-disk log format, so FileDb and NativeDb (of either package)
open each other's files.

Unlike the JAX package's `open_db("native")`, nothing falls back to FileDb:
a failed build raises with the compiler's message, a failed load with the
loader's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

from ..protocol.kv import Database

SRC = Path(__file__).resolve().parent / "zethdb.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_build_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile SRC (once per source hash); returns the library's path, or
    raises RuntimeError with g++'s output."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"zethdb-{h}"
    so = out_dir / "libzethdb.so"
    with _build_lock:
        if so.exists():
            return so
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libzethdb.{os.getpid()}.so"
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                                  capture_output=True, text=True)
        except OSError as exc:
            raise RuntimeError(f"zethdb: g++ could not run: {exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"zethdb: g++ failed ({proc.returncode}) on {SRC}:\n"
                               f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, so)
        return so


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.zethdb_open.restype = ctypes.c_void_p
        lib.zethdb_open.argtypes = [ctypes.c_char_p]
        lib.zethdb_put.restype = ctypes.c_int
        lib.zethdb_put.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.zethdb_get.restype = ctypes.c_int
        lib.zethdb_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.zethdb_del.restype = ctypes.c_int
        lib.zethdb_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
        lib.zethdb_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.zethdb_close.argtypes = [ctypes.c_void_p]
        lib.zethdb_count.restype = ctypes.c_uint64
        lib.zethdb_count.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativeDb(Database):
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lib = load()
        self._h = self._lib.zethdb_open(path.encode())
        if not self._h:
            raise OSError(f"zethdb_open failed for {path}")

    def get(self, key: bytes) -> Optional[bytes]:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint32()
        rc = self._lib.zethdb_get(
            self._h, bytes(key), len(key), ctypes.byref(out), ctypes.byref(out_len)
        )
        if rc != 1:
            return None
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._lib.zethdb_free(out)

    def put(self, key: bytes, value: bytes) -> None:
        rc = self._lib.zethdb_put(self._h, bytes(key), len(key), bytes(value), len(value))
        if rc != 0:
            raise OSError("zethdb_put failed")

    def delete(self, key: bytes) -> Optional[bytes]:
        old = self.get(key)
        if old is not None and self._lib.zethdb_del(self._h, bytes(key), len(key)) < 0:
            raise OSError("zethdb_del failed")
        return old

    def count(self) -> int:
        return int(self._lib.zethdb_count(self._h))

    def close(self):
        if self._h:
            self._lib.zethdb_close(self._h)
            self._h = None
