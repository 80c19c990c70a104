"""The port's node utilities against the JAX package's, on the same inputs.

RLP (both halves), secp256k1 (RFC 6979 signing, recovery, v and parity),
legacy and typed raw transactions (sign, encode, hash, decode, recover),
Merkle-Patricia roots, block-header hashes and receipts (roots and blooms).
The inputs are the vectors of the JAX package's test_signing.py,
test_mpt.py, test_receipts.py and test_canonical_hashes.py, and values drawn
from a numpy seed.  Every output must be equal, byte for byte; where the JAX
function raises, the port raises the same error.
"""

import numpy as np
import pytest

from eigen_zeth_tpu.utils import ethtx as j_ethtx
from eigen_zeth_tpu.utils import header as j_header
from eigen_zeth_tpu.utils import mpt as j_mpt
from eigen_zeth_tpu.utils import receipts as j_rc
from eigen_zeth_tpu.utils import rlp as j_rlp
from eigen_zeth_tpu.utils import secp256k1 as j_secp
from eigen_zeth_tpu_torch.ops import keccak
from eigen_zeth_tpu_torch.utils import ethtx, header, mpt, receipts as rc, rlp, secp256k1

EIP155_PRIV = 0x4646464646464646464646464646464646464646464646464646464646464646
EIP155_TX = {
    "nonce": 9, "gasPrice": 20 * 10**9, "gas": 21000,
    "to": "0x3535353535353535353535353535353535353535", "value": 10**18, "input": "0x",
}
MAINNET_GENESIS = {
    "parentHash": "0x" + "00" * 32,
    "miner": "0x" + "00" * 20,
    "stateRoot": "0xd7f8974fb5ac78d9ac099b9ad5018bedc2ce0a72dad1827a1709da30580f0544",
    "transactionsRoot": "0x56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421",
    "receiptsRoot": "0x56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421",
    "logsBloom": "0x" + "00" * 256,
    "difficulty": "0x400000000",
    "number": "0x0",
    "gasLimit": "0x1388",
    "gasUsed": "0x0",
    "timestamp": "0x0",
    "extraData": "0x11bbe8db4e347b4e8c937c1c8370e4b5ed33adb3db69cbdb7a38e1e50b1b82fa",
    "mixHash": "0x" + "00" * 32,
    "nonce": "0x0000000000000042",
}


def outcome(fn, *args):
    """fn's value, or the type and text of what it raised."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        return ("raised", type(e).__name__, str(e))


def random_item(rng, depth: int = 0):
    kind = int(rng.integers(0, 4 if depth < 3 else 2))
    if kind == 0:  # a short or long string, single bytes under 0x80 included
        n = int(rng.choice([0, 1, 1, 2, 20, 55, 56, 57, 300]))
        return rng.bytes(n)
    if kind == 1:
        return int(rng.integers(0, 1 << 62)) * int(rng.integers(0, 1 << 40))
    return [random_item(rng, depth + 1) for _ in range(int(rng.integers(0, 6)))]


def addr(rng) -> str:
    return "0x" + rng.bytes(20).hex()


@pytest.mark.parametrize("seed", range(3))
def test_rlp_encode_decode_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        item = random_item(rng)
        enc = rlp.encode(item)
        assert enc == j_rlp.encode(item)
        assert rlp.decode(enc) == j_rlp.decode(enc)
        if isinstance(item, int):
            assert rlp.decode_int(rlp.decode(enc)) == j_rlp.decode_int(j_rlp.decode(enc)) == item


MALFORMED = [
    b"", b"\x81\x05", b"\x82\x01", b"\xb8\x05abcde", b"\xb9\x00\x40" + bytes(64),
    b"\xc3\x01\x02", b"\xf8\x02\x01\x02", b"\xc2\x83ab", b"\x01\x02", b"\xc1\x01\x02",
]


@pytest.mark.parametrize("raw", MALFORMED, ids=lambda b: b.hex() or "empty")
def test_rlp_malformed_input_raises_alike(raw):
    assert outcome(rlp.decode, raw) == outcome(j_rlp.decode, raw)
    assert outcome(rlp.decode_int, raw) == outcome(j_rlp.decode_int, raw)


def test_secp256k1_sign_recover_equal():
    rng = np.random.default_rng(5)
    keys = [1, EIP155_PRIV] + [int.from_bytes(rng.bytes(32), "big") % secp256k1.N or 1
                               for _ in range(4)]
    for priv in keys:
        digest = rng.bytes(32)
        sig = secp256k1.sign(digest, priv)
        assert sig == j_secp.sign(digest, priv)
        assert sig[2] <= secp256k1.N // 2
        assert secp256k1.recover(digest, *sig) == j_secp.recover(digest, *sig)
        assert secp256k1.recover_address(digest, *sig) == j_secp.recover_address(digest, *sig)
        assert secp256k1.priv_to_address(priv) == j_secp.priv_to_address(priv)
        # a wrong parity or r out of range
        bad = (sig[0] ^ 1, sig[1], sig[2])
        assert secp256k1.recover_address(digest, *bad) == j_secp.recover_address(digest, *bad)
        assert (secp256k1.recover_address(digest, 0, secp256k1.N, 1)
                == j_secp.recover_address(digest, 0, secp256k1.N, 1))
    for yp in (0, 1):
        for cid in (None, 1, 12345):
            v = secp256k1.v_from_parity(yp, cid)
            assert v == j_secp.v_from_parity(yp, cid)
            assert secp256k1.parity_from_v(v) == j_secp.parity_from_v(v)
    for v in (0, 5, 26, 29, 34):
        assert outcome(secp256k1.parity_from_v, v) == outcome(j_secp.parity_from_v, v)


@pytest.mark.parametrize("k", [0, 1, 2, 3, 0xFFFF, secp256k1.N - 1, secp256k1.N,
                               secp256k1.N + 1, 2 * secp256k1.N, (1 << 256) - 1])
def test_secp256k1_ec_mul_equals_the_affine_chain(k):
    """The port's Jacobian ec_mul against the JAX package's affine one, at
    scalars around the group order, on G and on a point of its own."""
    point = j_secp.ec_mul(0xC0FFEE, j_secp.G)
    for p in (secp256k1.G, point):
        assert secp256k1.ec_mul(k, p) == j_secp.ec_mul(k, p)


def test_secp256k1_recover_edges_equal():
    """Recovery where z = 0 (u1·G is infinity) and where s·R = z·G (the sum
    is infinity, so no key), both packages alike."""
    rng = np.random.default_rng(9)
    for _ in range(3):
        k = int.from_bytes(rng.bytes(32), "big") % secp256k1.N or 1
        rx, ry = j_secp.ec_mul(k, j_secp.G)
        s = int.from_bytes(rng.bytes(32), "big") % secp256k1.N or 1
        for z in (0, s * k % secp256k1.N):
            digest = z.to_bytes(32, "big")
            args = (digest, ry & 1, rx % secp256k1.N, s)
            assert secp256k1.recover(*args) == j_secp.recover(*args)
            assert secp256k1.recover_address(*args) == j_secp.recover_address(*args)
        assert secp256k1.recover(*args) is None


@pytest.mark.parametrize("chain_id", [1, 777, 12345])
def test_legacy_tx_sign_encode_decode_recover_equal(chain_id):
    rng = np.random.default_rng(chain_id)
    txs = [EIP155_TX] + [
        {"nonce": int(rng.integers(0, 1 << 20)), "gasPrice": hex(int(rng.integers(1, 1 << 40))),
         "gas": int(rng.integers(21000, 1 << 24)),
         "to": None if i == 0 else addr(rng), "value": hex(int(rng.integers(0, 1 << 62))),
         "input": "0x" + rng.bytes(int(rng.integers(0, 100))).hex()}
        for i in range(2)
    ]
    for i, tx in enumerate(txs):
        priv = EIP155_PRIV + i
        assert ethtx.legacy_sighash(tx, chain_id) == j_ethtx.legacy_sighash(tx, chain_id)
        assert ethtx.legacy_sighash(tx, None) == j_ethtx.legacy_sighash(tx, None)
        signed = ethtx.sign_legacy_tx(tx, chain_id, priv)
        assert signed == j_ethtx.sign_legacy_tx(tx, chain_id, priv)
        raw = ethtx.encode_signed_raw(signed, chain_id)
        assert raw == j_ethtx.encode_signed_raw(signed, chain_id)
        assert ethtx.tx_hash(signed, chain_id) == j_ethtx.tx_hash(signed, chain_id)
        sender = ethtx.recover_sender(signed, chain_id)
        assert sender == j_ethtx.recover_sender(signed, chain_id)
        assert sender == secp256k1.priv_to_address(priv).lower()
        tampered = dict(signed, value=hex(rlp.tx_int(signed["value"]) + 1))
        assert ethtx.recover_sender(tampered, chain_id) == j_ethtx.recover_sender(
            tampered, chain_id)
        assert ethtx.recover_sender(dict(signed, v="0x5"), chain_id) is None
        decoded = ethtx.decode_raw_tx(raw)
        assert decoded == j_ethtx.decode_raw_tx(raw)
        assert decoded["from"] == sender and decoded["hash"] == "0x" + keccak.keccak256_host(
            raw).hex()
        assert rlp.encode_legacy_tx(signed, chain_id) == j_rlp.encode_legacy_tx(signed, chain_id)
    if chain_id == 1:  # the EIP-155 spec example
        assert ethtx.legacy_sighash(EIP155_TX, 1).hex() == (
            "daf5a779ae972f972197303d7b574746c7ef83eadac0f2791ad23db92e4c8e53")


def typed_raw(tx_type: int, rng, priv: int, chain_id: int = 12345) -> bytes:
    """A signed typed envelope (0x01, 0x02 or 0x03), RLP items as the wire
    carries them."""
    acl = [[rng.bytes(20), [rng.bytes(32) for _ in range(int(rng.integers(0, 3)))]]
           for _ in range(int(rng.integers(0, 3)))]
    nonce, gas, value = int(rng.integers(0, 99)), int(rng.integers(21000, 10**6)), int(
        rng.integers(0, 10**9))
    to, data = rng.bytes(20), rng.bytes(int(rng.integers(0, 70)))
    if tx_type == 1:
        items = [chain_id, nonce, int(rng.integers(1, 10**10)), gas, to, value, data, acl]
    elif tx_type == 2:
        items = [chain_id, nonce, int(rng.integers(1, 10**9)), int(rng.integers(10**9, 10**10)),
                 gas, to, value, data, acl]
    else:
        hashes = [b"\x01" + rng.bytes(31) for _ in range(int(rng.integers(1, 4)))]
        items = [chain_id, nonce, int(rng.integers(1, 10**9)), int(rng.integers(10**9, 10**10)),
                 gas, to, value, data, acl, int(rng.integers(1, 10**6)), hashes]
    digest = keccak.keccak256_host(bytes([tx_type]) + rlp.encode(items))
    yp, r, s = secp256k1.sign(digest, priv)
    return bytes([tx_type]) + rlp.encode(items + [yp, r, s])


@pytest.mark.parametrize("tx_type", [1, 2, 3])
def test_typed_raw_tx_decode_equal(tx_type):
    rng = np.random.default_rng(100 + tx_type)
    for i in range(4):
        priv = 0xC0FFEE + i
        raw = typed_raw(tx_type, rng, priv)
        decoded = ethtx.decode_raw_tx(raw)
        assert decoded == j_ethtx.decode_raw_tx(raw)
        assert decoded["from"] == secp256k1.priv_to_address(priv).lower()
    # malformed: an empty input, a truncated envelope, a blob tx without a 'to'
    assert outcome(ethtx.decode_raw_tx, b"") == outcome(j_ethtx.decode_raw_tx, b"")
    raw = typed_raw(tx_type, rng, 7)
    assert outcome(ethtx.decode_raw_tx, raw[:-3]) == outcome(j_ethtx.decode_raw_tx, raw[:-3])


@pytest.mark.parametrize("seed", range(3))
def test_mpt_roots_equal(seed):
    rng = np.random.default_rng(seed)
    assert mpt.EMPTY_ROOT == j_mpt.EMPTY_ROOT
    for n in (0, 1, 2, 3, 17, 100):
        # short keys share prefixes, so branches, extensions and inline nodes all occur
        keys = [rng.bytes(int(rng.integers(1, 4))) for _ in range(n)]
        items = {k: rng.bytes(int(rng.integers(1, 40))) for k in keys}
        assert mpt.trie_root(items) == j_mpt.trie_root(items)
        assert mpt.secure_root(items) == j_mpt.secure_root(items)
        values = list(items.values())
        assert mpt.index_root(values) == j_mpt.index_root(values)


def test_header_hashes_equal():
    assert header.EMPTY_OMMERS_HASH == j_header.EMPTY_OMMERS_HASH
    want = "0xd4e56740f876aef8c010b86a40d5f56745a118d0906a34e69aec8c0db1cb8fa3"
    assert header.block_hash(MAINNET_GENESIS) == j_header.block_hash(MAINNET_GENESIS) == want
    rng = np.random.default_rng(9)
    tails = [("baseFeePerGas", lambda: hex(int(rng.integers(0, 10**10)))),
             ("withdrawalsRoot", lambda: "0x" + rng.bytes(32).hex()),
             ("blobGasUsed", lambda: hex(int(rng.integers(0, 10**6)))),
             ("excessBlobGas", lambda: hex(int(rng.integers(0, 10**6)))),
             ("parentBeaconBlockRoot", lambda: "0x" + rng.bytes(32).hex())]
    for k in range(len(tails) + 1):  # each fork's tail of fields
        blk = dict(MAINNET_GENESIS, number=hex(int(rng.integers(0, 10**7))),
                   stateRoot="0x" + rng.bytes(32).hex(), timestamp=hex(int(rng.integers(0, 2**40))),
                   extraData="0x" + rng.bytes(int(rng.integers(0, 33))).hex())
        blk.update({name: make() for name, make in tails[:k]})
        assert header.encode_header(blk) == j_header.encode_header(blk)
        assert header.block_hash(blk) == j_header.block_hash(blk)


@pytest.mark.parametrize("seed", range(2))
def test_receipts_roots_and_blooms_equal(seed):
    rng = np.random.default_rng(seed)
    assert rc.receipts_root([]) == j_rc.receipts_root([]) == mpt.EMPTY_ROOT
    receipts = []
    for _ in range(12):
        logs = [{"address": addr(rng),
                 "topics": ["0x" + rng.bytes(32).hex() for _ in range(int(rng.integers(0, 5)))],
                 "data": "0x" + rng.bytes(int(rng.integers(0, 80))).hex()}
                for _ in range(int(rng.integers(0, 4)))]
        receipts.append({"status": int(rng.integers(0, 2)),
                         "gasUsed": int(rng.integers(21000, 10**6)), "logs": logs})
        assert rc.logs_bloom(logs) == j_rc.logs_bloom(logs)
        assert rc.encode_receipt(1, 77, logs) == j_rc.encode_receipt(1, 77, logs)
        assert rc.receipts_root(receipts) == j_rc.receipts_root(receipts)
        bloom = rc.block_bloom(receipts)
        assert bloom == j_rc.block_bloom(receipts)
        for item in (bytes.fromhex(addr(rng)[2:]), rng.bytes(32)):
            assert rc.bloom_contains(bloom, item) == j_rc.bloom_contains(bloom, item)
            as_int = int.from_bytes(bloom, "big")
            assert rc.bloom_contains(as_int, item) == j_rc.bloom_contains(as_int, item)
