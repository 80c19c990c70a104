"""The port's native zethdb engine (native/zethdb.{cpp,py}) against the JAX
package's FileDb and NativeDb.

- The operations of tests/test_native_db.py (overwrite, binary values,
  delete, reopen, typed helpers) through the port's NativeDb, and the files
  they leave equal byte for byte to the JAX package's FileDb doing the same.
- Files written by either package's engines open in the port's, and the
  port's in theirs, in both directions.
- `open_db("native")` returns the port's engine, and a build that fails
  raises with the compiler's message: no fallback to FileDb.
Tolerance: none, byte equality.  Skips where g++ is missing.
"""

import shutil

import pytest

from eigen_zeth_tpu.native import zethdb as j_zethdb
from eigen_zeth_tpu.protocol import kv as j_kv
from eigen_zeth_tpu_torch.native import zethdb
from eigen_zeth_tpu_torch.protocol import kv

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not available")


def script(db, k):
    """The operations of test_native_roundtrip and test_native_durability."""
    db.put(b"a", b"1")
    db.put(b"a", b"2")
    db.put(b"b", b"\x00\xff" * 100)
    db.put(b"k%d" % k, bytes(range(k)))
    assert db.get(b"a") == b"2"
    assert db.get(b"b") == b"\x00\xff" * 100
    assert db.delete(b"a") == b"2"
    assert db.get(b"a") is None
    assert db.delete(b"missing") is None
    db.put_u64(kv.KEY_NEXT_BATCH, 9)
    db.put_status(4, kv.Status.Submitted)


@pytest.mark.parametrize("k", [0, 3, 200])
def test_native_writes_the_jax_file_bytes(tmp_path, k):
    port, jax = tmp_path / "port.log", tmp_path / "jax.log"
    db = zethdb.NativeDb(str(port))
    script(db, k)
    assert db.count() == 4
    db.close()
    fdb = j_kv.FileDb(str(jax))
    script(fdb, k)
    fdb.close()
    assert port.read_bytes() == jax.read_bytes()
    db = zethdb.NativeDb(str(port))  # durability: the log replays
    assert (db.get_u64(kv.KEY_NEXT_BATCH), db.get_status(4)) == (9, kv.Status.Submitted)
    assert db.get(b"k%d" % k) == bytes(range(k))
    db.close()


@pytest.mark.parametrize("writer", ["jax-file", "jax-native"])
def test_interop_both_directions(tmp_path, writer):
    path = str(tmp_path / "x.log")
    make = j_kv.FileDb if writer == "jax-file" else j_zethdb.NativeDb
    jdb = make(path)
    jdb.put(b"k1", b"v1")
    jdb.put(b"k2", b"v2")
    jdb.delete(b"k1")
    jdb.close()

    ndb = zethdb.NativeDb(path)
    assert ndb.get(b"k1") is None
    assert ndb.get(b"k2") == b"v2"
    ndb.put(b"k3", b"v3")
    ndb.delete(b"k2")
    ndb.close()

    for reader in (j_kv.FileDb, j_zethdb.NativeDb, kv.FileDb):
        db = reader(path)
        assert (db.get(b"k1"), db.get(b"k2"), db.get(b"k3")) == (None, None, b"v3")
        db.close()


def test_open_db_native_and_no_fallback(tmp_path, monkeypatch):
    db = kv.open_db("native", str(tmp_path / "f.log"))
    assert isinstance(db, zethdb.NativeDb)
    db.put(b"z", b"9")
    assert db.get(b"z") == b"9"
    db.close()

    broken = tmp_path / "zethdb.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(zethdb, "SRC", broken)
    monkeypatch.setattr(zethdb, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(zethdb, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        kv.open_db("native", str(tmp_path / "g.log"))
    assert not (tmp_path / "g.log").exists()
