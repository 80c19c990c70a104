"""Minimal Ethereum ABI encoder — selectors + head/tail encoding.

Supports the types the EigenZkVM surface needs (contracts/EigenZkVM.json;
reference call sites src/settlement/ethereum/interfaces/zkvm.rs):
uint<N>, bool, address, bytes32, bytes, static/dynamic tuples, fixed and
dynamic arrays.  Implemented from the ABI spec; no external web3 deps.

Type syntax: python-structured, not string-parsed —
  ("uint", 256) | ("bool",) | ("address",) | ("bytes32",) | ("bytes",)
  ("tuple", [t...]) | ("array", t, n) | ("array", t, None)   # None=dynamic

A copy of eigen_zeth_tpu/settlement/abi.py.
"""

from __future__ import annotations

from ..ops import keccak


def selector(signature: str) -> bytes:
    """4-byte function selector: keccak256(signature)[:4]."""
    return keccak.keccak256_host(signature.encode())[:4]


def _is_dynamic(t) -> bool:
    kind = t[0]
    if kind == "bytes" or kind == "string":
        return True
    if kind == "array":
        _, elem, n = t
        return n is None or _is_dynamic(elem)
    if kind == "tuple":
        return any(_is_dynamic(x) for x in t[1])
    return False


def _enc_uint(v: int) -> bytes:
    v = int(v)
    assert 0 <= v < (1 << 256)
    return v.to_bytes(32, "big")


def _enc_static(t, v) -> bytes:
    kind = t[0]
    if kind == "uint":
        return _enc_uint(v)
    if kind == "bool":
        return _enc_uint(1 if v else 0)
    if kind == "address":
        if isinstance(v, str):
            v = int(v, 16) if v.startswith("0x") else int(v, 16)
        if isinstance(v, bytes):
            v = int.from_bytes(v, "big")
        return _enc_uint(v)
    if kind == "bytes32":
        b = bytes(v)
        assert len(b) == 32
        return b
    if kind == "tuple":
        return encode(t[1], list(v))
    if kind == "array":
        _, elem, n = t
        assert n is not None and len(v) == n
        return encode([elem] * n, list(v))
    raise ValueError(f"not a static type: {t}")


def _enc_dynamic(t, v) -> bytes:
    kind = t[0]
    if kind in ("bytes", "string"):
        b = v.encode() if isinstance(v, str) else bytes(v)
        padded = b + b"\x00" * ((32 - len(b) % 32) % 32)
        return _enc_uint(len(b)) + padded
    if kind == "array":
        _, elem, n = t
        if n is None:
            return _enc_uint(len(v)) + encode([elem] * len(v), list(v))
        return encode([elem] * n, list(v))
    if kind == "tuple":
        return encode(t[1], list(v))
    raise ValueError(f"not a dynamic type: {t}")


def encode(types, values) -> bytes:
    """Head/tail encoding of a sequence of typed values."""
    assert len(types) == len(values)
    heads = []
    tails = []
    # head size = 32 per element (static elements inline their full size)
    head_sizes = []
    for t in types:
        head_sizes.append(32 if _is_dynamic(t) else len(_enc_static(t, _zero(t))))
    total_head = sum(head_sizes)
    offset = total_head
    for t, v in zip(types, values):
        if _is_dynamic(t):
            tail = _enc_dynamic(t, v)
            heads.append(_enc_uint(offset))
            tails.append(tail)
            offset += len(tail)
        else:
            heads.append(_enc_static(t, v))
    return b"".join(heads) + b"".join(tails)


def _zero(t):
    kind = t[0]
    if kind == "uint":
        return 0
    if kind == "bool":
        return False
    if kind == "address":
        return 0
    if kind == "bytes32":
        return b"\x00" * 32
    if kind == "tuple":
        return [_zero(x) for x in t[1]]
    if kind == "array":
        _, elem, n = t
        return [_zero(elem)] * (n or 0)
    raise ValueError(t)


def encode_call(signature: str, types, values) -> bytes:
    return selector(signature) + encode(types, values)
