"""RLP encoding and decoding — a copy of eigen_zeth_tpu/utils/rlp.py, for
legacy-transaction batch packing and eth_sendRawTransaction ingestion.

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


def _decode_at(data: bytes, i: int):
    """Decode one item starting at offset i; returns (item, next_offset).
    Items are bytes or (recursively) lists of items."""
    if i >= len(data):
        raise ValueError("rlp: truncated input")
    b0 = data[i]
    if b0 < 0x80:  # single byte
        return data[i : i + 1], i + 1
    if b0 < 0xB8:  # short string
        n = b0 - 0x80
        end = i + 1 + n
        if end > len(data):
            raise ValueError("rlp: truncated string")
        s = data[i + 1 : end]
        if n == 1 and s[0] < 0x80:
            raise ValueError("rlp: non-canonical single byte")
        return s, end
    if b0 < 0xC0:  # long string
        ln = b0 - 0xB7
        n = int.from_bytes(data[i + 1 : i + 1 + ln], "big")
        if n < 56 or (ln and data[i + 1] == 0):
            raise ValueError("rlp: non-canonical length")
        end = i + 1 + ln + n
        if end > len(data):
            raise ValueError("rlp: truncated string")
        return data[i + 1 + ln : end], end
    if b0 < 0xF8:  # short list
        n = b0 - 0xC0
        end = i + 1 + n
        j = i + 1
    else:  # long list
        ln = b0 - 0xF7
        n = int.from_bytes(data[i + 1 : i + 1 + ln], "big")
        if n < 56 or (ln and data[i + 1] == 0):
            raise ValueError("rlp: non-canonical length")
        j = i + 1 + ln
        end = j + n
    if end > len(data):
        raise ValueError("rlp: truncated list")
    items = []
    while j < end:
        item, j = _decode_at(data, j)
        items.append(item)
    if j != end:
        raise ValueError("rlp: list payload overrun")
    return items, end


def decode(data: bytes):
    """Decode exactly one RLP item; trailing bytes are an error."""
    item, end = _decode_at(bytes(data), 0)
    if end != len(data):
        raise ValueError("rlp: trailing bytes")
    return item


def decode_int(b: bytes) -> int:
    if b and b[0] == 0:
        raise ValueError("rlp: leading zero in integer")
    return int.from_bytes(b, "big")


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
