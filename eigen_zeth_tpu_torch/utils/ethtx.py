"""Ethereum legacy-transaction signing / sender recovery (EIP-155).

The reference signs settlement txs with ethers local wallets
(src/settlement/ethereum/mod.rs:97-120) and relies on revm's secp256k1
for sender recovery.  This module is the host-side equivalent: build the
EIP-155 signing payload, sign with utils/secp256k1, emit the raw signed
RLP a stock JSON-RPC node accepts via eth_sendRawTransaction, and
recover senders of incoming txs.

A copy of eigen_zeth_tpu/utils/ethtx.py.
"""

from __future__ import annotations

from ..ops import keccak
from . import rlp, secp256k1


def _tx_fields(tx: dict, chain_id: int):
    to = tx.get("to")
    return [
        rlp.tx_int(tx.get("nonce")),
        rlp.tx_int(tx.get("gasPrice")),
        rlp.tx_int(tx.get("gas")),
        bytes.fromhex(to[2:]) if to else b"",
        rlp.tx_int(tx.get("value")),
        bytes.fromhex(tx.get("input", tx.get("data", "0x"))[2:]),
    ]


def legacy_sighash(tx: dict, chain_id: int | None) -> bytes:
    """keccak of the signing payload: rlp([n,gp,g,to,v,d,cid,0,0]) with
    EIP-155 replay protection, rlp([n,gp,g,to,v,d]) pre-155."""
    fields = _tx_fields(tx, chain_id)
    if chain_id is not None:
        fields += [chain_id, 0, 0]
    return keccak.keccak256_host(rlp.encode(fields))


def sign_legacy_tx(tx: dict, chain_id: int, priv: int) -> dict:
    """Sign in place-style: returns a new tx dict with v, r, s set."""
    yp, r, s = secp256k1.sign(legacy_sighash(tx, chain_id), priv)
    v = secp256k1.v_from_parity(yp, chain_id)
    out = dict(tx)
    out["chainId"] = hex(chain_id)
    out["v"], out["r"], out["s"] = hex(v), hex(r), hex(s)
    return out


def encode_signed_raw(tx: dict, chain_id: int) -> bytes:
    """Raw signed RLP for eth_sendRawTransaction."""
    v = rlp.tx_int(tx.get("v"))
    r = rlp.tx_int(tx.get("r"))
    s = rlp.tx_int(tx.get("s"))
    return rlp.encode(_tx_fields(tx, chain_id) + [v, r, s])


def tx_hash(tx: dict, chain_id: int) -> bytes:
    return keccak.keccak256_host(encode_signed_raw(tx, chain_id))


def recover_sender(tx: dict, default_chain_id: int):
    """Sender address of a signed legacy tx, or None if unrecoverable."""
    v = rlp.tx_int(tx.get("v"))
    r = rlp.tx_int(tx.get("r"))
    s = rlp.tx_int(tx.get("s"))
    try:
        yp, chain_id = secp256k1.parity_from_v(v)
    except ValueError:
        return None
    digest = legacy_sighash(tx, chain_id)  # None -> pre-155 payload
    return secp256k1.recover_address(digest, yp, r, s)


def _hx(b: bytes) -> str:
    return "0x" + (b.hex() or "0")


def decode_raw_tx(raw: bytes) -> dict:
    """Decode a raw signed transaction (the eth_sendRawTransaction wire
    format reth accepts) into this framework's tx dict, recovering the
    sender.  Supports legacy/EIP-155 RLP and the typed envelopes
    0x01 (EIP-2930) / 0x02 (EIP-1559); typed txs are mapped onto the
    internal gasPrice field (maxFeePerGas is charged as given — the
    documented fee-market simplification in sequencer/evm.py)."""
    raw = bytes(raw)
    if not raw:
        raise ValueError("empty raw tx")
    if raw[0] == 0x03:  # EIP-4844 blob transaction
        items = rlp.decode(raw[1:])
        (cid, nonce, prio, max_fee, gas, to, value, data, acl,
         max_blob_fee, blob_hashes, yp, r, s) = items
        chain_id = rlp.decode_int(cid)
        sighash = keccak.keccak256_host(b"\x03" + rlp.encode(items[:-3]))
        sender = secp256k1.recover_address(
            sighash, rlp.decode_int(yp), rlp.decode_int(r), rlp.decode_int(s)
        )
        if sender is None:
            raise ValueError("invalid signature: sender unrecoverable")
        if not to:
            raise ValueError("blob tx must have a 'to' address")
        tx = {
            "hash": "0x" + keccak.keccak256_host(raw).hex(),
            "type": "0x3",
            "from": sender,
            "nonce": _hx(nonce),
            "maxFeePerGas": hex(rlp.decode_int(max_fee)),
            "maxPriorityFeePerGas": hex(rlp.decode_int(prio)),
            "maxFeePerBlobGas": hex(rlp.decode_int(max_blob_fee)),
            "blobVersionedHashes": ["0x" + h.hex() for h in blob_hashes],
            "accessList": [
                {
                    "address": "0x" + a.hex(),
                    "storageKeys": ["0x" + k.hex() for k in keys],
                }
                for a, keys in (acl or [])
            ],
            "gas": _hx(gas),
            "to": "0x" + to.hex(),
            "value": _hx(value),
            "input": "0x" + data.hex(),
            "v": hex(27 + rlp.decode_int(yp)),
            "r": _hx(r),
            "s": _hx(s),
            "chainId": hex(chain_id),
        }
        return tx
    if raw[0] in (0x01, 0x02):  # typed envelope
        tx_type = raw[0]
        items = rlp.decode(raw[1:])
        if tx_type == 0x02:
            (cid, nonce, _prio, max_fee, gas, to, value, data,
             _acl, yp, r, s) = items
            gas_price = rlp.decode_int(max_fee)
        else:  # 0x01
            (cid, nonce, gp, gas, to, value, data, _acl, yp, r, s) = items
            gas_price = rlp.decode_int(gp)
        chain_id = rlp.decode_int(cid)
        sighash = keccak.keccak256_host(bytes([tx_type]) + rlp.encode(items[:-3]))
        sender = secp256k1.recover_address(
            sighash, rlp.decode_int(yp), rlp.decode_int(r), rlp.decode_int(s)
        )
        # normalized v carries the parity; chainId rides its own field
        v = 27 + rlp.decode_int(yp)
    else:  # legacy
        items = rlp.decode(raw)
        if not isinstance(items, list) or len(items) != 9:
            raise ValueError("legacy tx must be a 9-item RLP list")
        nonce, gp, gas, to, value, data, v_b, r, s = items
        gas_price = rlp.decode_int(gp)
        v = rlp.decode_int(v_b)
        yp, chain_id = secp256k1.parity_from_v(v)
        payload = [nonce, gp, gas, to, value, data]
        if chain_id is not None:
            payload += [chain_id, 0, 0]
        sighash = keccak.keccak256_host(rlp.encode(payload))
        sender = secp256k1.recover_address(
            sighash, yp, rlp.decode_int(r), rlp.decode_int(s)
        )
    if sender is None:
        raise ValueError("invalid signature: sender unrecoverable")
    tx = {
        # canonical tx hash: keccak of the signed envelope wire bytes —
        # identical for legacy RLP and typed (type || rlp) envelopes
        "hash": "0x" + keccak.keccak256_host(raw).hex(),
        "from": sender,
        "nonce": _hx(items[1] if raw[0] in (0x01, 0x02) else items[0]),
        "gasPrice": hex(gas_price),
        "gas": _hx(gas),
        "to": ("0x" + to.hex()) if to else None,
        "value": _hx(value),
        "input": "0x" + data.hex(),
        "v": hex(v),
        "r": _hx(r),
        "s": _hx(s),
    }
    if chain_id is not None:
        tx["chainId"] = hex(chain_id)
    return tx
