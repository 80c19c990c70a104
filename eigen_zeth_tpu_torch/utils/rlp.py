"""RLP encoding of legacy transactions — copy of the encoding half of
eigen_zeth_tpu/utils/rlp.py.

encode_legacy_tx is the exact packing the reference's rollup worker submits
on-chain (src/settlement/worker.rs:425-449, 477-554), and the chain
executor packs each sequenced transaction with it, so the chunk STARKs
commit to the bytes that settle.
"""

from __future__ import annotations


def encode_int(v: int) -> bytes:
    if v == 0:
        return b""
    return v.to_bytes((v.bit_length() + 7) // 8, "big")


def encode(item) -> bytes:
    """item: bytes | int | list (recursively)."""
    if isinstance(item, int):
        return encode(encode_int(item))
    if isinstance(item, (bytes, bytearray)):
        b = bytes(item)
        if len(b) == 1 and b[0] < 0x80:
            return b
        return _len_prefix(len(b), 0x80) + b
    if isinstance(item, (list, tuple)):
        payload = b"".join(encode(x) for x in item)
        return _len_prefix(len(payload), 0xC0) + payload
    raise TypeError(f"cannot RLP-encode {type(item)}")


def _len_prefix(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    lb = encode_int(length)
    return bytes([offset + 55 + len(lb)]) + lb


def tx_int(x, default: int = 0) -> int:
    """Coerce a JSON tx field (hex string / int / None) to int."""
    if x is None:
        return default
    return int(x, 16) if isinstance(x, str) and x.startswith("0x") else int(x)


def encode_legacy_tx(tx: dict, chain_id: int) -> bytes:
    """worker.rs:425-449 + 477-554: EIP-155 signing RLP of the legacy tx
    followed by v, r, s as decimal-string bytes."""
    to = tx.get("to")
    to_bytes = bytes.fromhex(to[2:]) if to else b""
    payload = encode(
        [
            tx_int(tx.get("nonce")),
            tx_int(tx.get("gasPrice")),
            tx_int(tx.get("gas")),
            to_bytes,
            tx_int(tx.get("value")),
            bytes.fromhex(tx.get("input", "0x")[2:]),
            tx_int(tx.get("chainId"), chain_id),
            0,
            0,
        ]
    )
    v = tx_int(tx.get("v"))
    r = tx_int(tx.get("r"))
    s = tx_int(tx.get("s"))
    return payload + str(v).encode() + str(r).encode() + str(s).encode()
