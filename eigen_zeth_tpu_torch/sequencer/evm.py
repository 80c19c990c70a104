"""Minimal EVM — accounts, storage, and a bytecode interpreter for the
sequencer's payload builder.

Fills the execution-layer role the reference gets from revm inside its
custom payload builder (src/custom_reth/mod.rs:564-676: per-tx
Evm::transact + commit).  A copy of eigen_zeth_tpu/sequencer/evm.py; it
provides:

  * Ethereum's account model — nonce / balance / code / storage — with
    the REAL state commitment: a secure Merkle-Patricia trie of
    rlp([nonce, balance, storage_root, code_hash]) (utils/mpt.py)
  * value transfers, contract creation (CREATE address =
    keccak(rlp([sender, nonce]))[12:]), and message calls through a
    stack-machine interpreter covering the core opcode set (arithmetic /
    comparison / keccak / environment / block context / memory / storage
    / control flow / PUSH-DUP-SWAP / LOG / CREATE / CREATE2 / CALL
    family / RETURN / REVERT), with tx.origin threaded through frames
  * consensus gas accounting (Shanghai level): the yellow-paper opcode
    schedule, EIP-2028 calldata pricing, EIP-2929 warm/cold access sets
    (revert-scoped) with EIP-2930 access lists and EIP-3651 warm
    coinbase, EIP-2200/3529 SSTORE pricing with capped refunds,
    quadratic memory expansion, EIP-150 63/64 call gas with the 2300
    value stipend, EIP-3860 initcode metering, code-deposit charging
    with EIP-170/3541 limits, and the EIP-1559 fee market
    (maxFeePerGas/maxPriorityFeePerGas, base-fee burn, tip to coinbase)

Precompiles: the full Ethereum 0x01-0x09 set — ecrecover, sha256,
ripemd160, identity, modexp (EIP-198/2565), BN254 ecadd/ecmul
(EIP-196), BN254 pairing check (EIP-197, backed by this framework's own
ops/pairing.py — the L2 can verify its own Groth16 proofs on-chain),
blake2f (EIP-152).
SELFDESTRUCT follows
EIP-6780 (sweep always; deletion scheduled at end of transaction only
for accounts created in the SAME tx, revert-scoped), BLOCKHASH does the
real last-256 canonical-hash lookup through BlockCtx.block_hash_fn, and
EIP-4844 blob transactions execute (type-3 decode + blob-gas accounting
in sequencer/chain.py; BLOBHASH serves the tx's versioned hashes and
BLOBBASEFEE the excess-blob-gas-derived fee).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..ops import keccak
from ..utils import mpt, rlp

U256 = (1 << 256) - 1
SIGN_BIT = 1 << 255

BLOCK_GAS_LIMIT = 30_000_000
INTRINSIC_GAS = 21_000
CREATE_GAS = 32_000
MAX_DEPTH = 1024


def _addr_bytes(addr: str) -> bytes:
    return bytes.fromhex(addr[2:].rjust(40, "0") if addr.startswith("0x") else addr)


def _to_addr(v: int) -> str:
    return "0x" + (v & ((1 << 160) - 1)).to_bytes(20, "big").hex()


@dataclass
class Account:
    nonce: int = 0
    balance: int = 0
    code: bytes = b""
    storage: Dict[int, int] = field(default_factory=dict)


class WorldState:
    """Account state with Ethereum's trie commitment; dev-net semantics
    auto-fund externally-owned accounts on first touch (the reference
    dev chain pre-funds from genesis)."""

    DEV_FUND = 10**24

    def __init__(self, auto_fund: bool = True):
        self.accounts: Dict[str, Account] = {}
        self.auto_fund = auto_fund

    def get(self, addr: str) -> Account:
        a = self.accounts.get(addr.lower())
        return a if a is not None else Account()

    def touch(self, addr: str, fund: bool = False) -> Account:
        """fund=True applies the dev-net auto-fund (tx SENDERS only — the
        reference dev chain pre-funds EOAs from genesis, never contracts)."""
        addr = addr.lower()
        if addr not in self.accounts:
            self.accounts[addr] = Account(
                balance=self.DEV_FUND if (fund and self.auto_fund) else 0
            )
        return self.accounts[addr]

    def snapshot(self):
        return {
            a: Account(acc.nonce, acc.balance, acc.code, dict(acc.storage))
            for a, acc in self.accounts.items()
        }

    def restore(self, snap) -> None:
        self.accounts = snap

    def state_root(self) -> bytes:
        items = {}
        for addr, acc in self.accounts.items():
            storage_items = {
                k.to_bytes(32, "big"): rlp.encode(rlp.encode_int(v))
                for k, v in acc.storage.items()
                if v
            }
            storage_root = mpt.secure_root(storage_items)
            code_hash = keccak.keccak256_host(acc.code)
            items[_addr_bytes(addr)] = rlp.encode(
                [
                    rlp.encode_int(acc.nonce),
                    rlp.encode_int(acc.balance),
                    storage_root,
                    code_hash,
                ]
            )
        return mpt.secure_root(items)


@dataclass
class BlockCtx:
    number: int = 0
    timestamp: int = 0
    coinbase: str = "0x" + "00" * 20
    gas_limit: int = BLOCK_GAS_LIMIT
    chain_id: int = 12345
    prevrandao: int = 0
    basefee: int = 0
    # EIP-4844 blob fee market: blob base fee derived from the parent's
    # excess_blob_gas (chain.py computes it; spec minimum 1)
    blob_basefee: int = 1
    # last-256 block hash lookup (BLOCKHASH); None -> dev-chain 0
    block_hash_fn: Optional[Callable[[int], int]] = None


@dataclass
class Log:
    address: str
    topics: List[int]
    data: bytes


class _Revert(Exception):
    def __init__(self, data: bytes, gas_left: int = 0):
        self.data = data
        self.gas_left = gas_left  # REVERT returns unconsumed gas


class _Halt(Exception):  # out of gas / invalid op / stack error
    pass


# consensus gas schedule (Shanghai-level: yellow paper Appendix G +
# EIP-2929 warm/cold access, EIP-2200/3529 SSTORE & refunds, EIP-3860
# initcode metering).
G_ZERO = 0
G_JUMPDEST = 1
G_BASE = 2
G_VERYLOW = 3
G_LOW = 5
G_MID = 8
G_HIGH = 10
G_EXP = 10
G_EXPBYTE = 50
G_SHA3 = 30
G_SHA3WORD = 6
G_MEMWORD = 3
G_COPYWORD = 3
G_LOG = 375
G_LOGDATA = 8
G_LOGTOPIC = 375
G_CREATE = 32_000
G_CODEDEPOSIT = 200
G_INITCODE_WORD = 2  # EIP-3860
G_CALLVALUE = 9_000
G_CALLSTIPEND = 2_300
G_NEWACCOUNT = 25_000
G_SELFDESTRUCT = 5_000
# EIP-2929
G_WARM_ACCESS = 100
G_COLD_ACCOUNT = 2_600
G_COLD_SLOAD = 2_100
# EIP-2200 / EIP-3529
G_SSTORE_SET = 20_000
G_SSTORE_RESET = 2_900  # 5000 - COLD_SLOAD
G_SSTORE_SENTRY = 2_300
R_SCLEAR = 4_800  # EIP-3529 clear refund
MAX_REFUND_QUOTIENT = 5  # EIP-3529: refund <= gas_used / 5
# EIP-2930 access-list intrinsic costs
G_ACCESSLIST_ADDR = 2_400
G_ACCESSLIST_KEY = 1_900
# EIP-2028 calldata
G_TXDATA_ZERO = 4
G_TXDATA_NONZERO = 16
# EIP-4844 blob gas market
GAS_PER_BLOB = 1 << 17
TARGET_BLOB_GAS_PER_BLOCK = 3 * GAS_PER_BLOB
MAX_BLOB_GAS_PER_BLOCK = 6 * GAS_PER_BLOB
MIN_BLOB_BASE_FEE = 1
BLOB_BASE_FEE_UPDATE_FRACTION = 3_338_477


def blob_base_fee(excess_blob_gas: int) -> int:
    """EIP-4844 fake_exponential(MIN, excess, FRACTION): the block's
    blob base fee from its excess blob gas."""
    i, output, acc = 1, 0, MIN_BLOB_BASE_FEE * BLOB_BASE_FEE_UPDATE_FRACTION
    while acc > 0:
        output += acc
        acc = acc * excess_blob_gas // (BLOB_BASE_FEE_UPDATE_FRACTION * i)
        i += 1
    return output // BLOB_BASE_FEE_UPDATE_FRACTION

# static per-opcode base cost; dynamic parts (memory, access, copies,
# storage) are charged at the op sites below
_OP_GAS: Dict[int, int] = {}
for _o in (0x00, 0xF3, 0xFD):  # STOP RETURN REVERT
    _OP_GAS[_o] = G_ZERO
for _o in (0x30, 0x32, 0x33, 0x34, 0x36, 0x38, 0x3A, 0x3D, 0x41, 0x42,
           0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x4A, 0x50, 0x58, 0x59,
           0x5A, 0x5F):
    _OP_GAS[_o] = G_BASE  # ADDRESS..BASEFEE, POP, PC, MSIZE, GAS, PUSH0
for _o in (0x01, 0x03, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17,
           0x18, 0x19, 0x1A, 0x1B, 0x1C, 0x1D, 0x35, 0x51, 0x52, 0x53,
           0x49):
    _OP_GAS[_o] = G_VERYLOW
for _o in range(0x60, 0xA0):  # PUSHn DUPn SWAPn
    _OP_GAS[_o] = G_VERYLOW
for _o in (0x02, 0x04, 0x05, 0x06, 0x07, 0x0B):  # MUL DIV SDIV MOD SMOD SIGNEXTEND
    _OP_GAS[_o] = G_LOW
for _o in (0x08, 0x09, 0x56):  # ADDMOD MULMOD JUMP
    _OP_GAS[_o] = G_MID
_OP_GAS[0x57] = G_HIGH  # JUMPI
_OP_GAS[0x0A] = G_EXP
_OP_GAS[0x20] = G_SHA3
_OP_GAS[0x5B] = G_JUMPDEST
for _o in (0x37, 0x39, 0x3E, 0x5E):  # CALLDATACOPY CODECOPY RETURNDATACOPY MCOPY
    _OP_GAS[_o] = G_VERYLOW
for _o in (0x31, 0x3B, 0x3C, 0x3F):  # BALANCE EXTCODESIZE/COPY/HASH: 2929 at site
    _OP_GAS[_o] = 0
for _o in (0x54, 0x55):  # SLOAD SSTORE: 2929/2200 at site
    _OP_GAS[_o] = 0
for _o in (0x5C, 0x5D):  # TLOAD TSTORE (EIP-1153)
    _OP_GAS[_o] = G_WARM_ACCESS
_OP_GAS[0x40] = 20  # BLOCKHASH
for _o in (0xA0, 0xA1, 0xA2, 0xA3, 0xA4):  # LOGn: dynamic at site
    _OP_GAS[_o] = 0
for _o in (0xF0, 0xF5):  # CREATE/CREATE2: dynamic at site
    _OP_GAS[_o] = 0
for _o in (0xF1, 0xF4, 0xFA):  # CALL family: 2929 at site
    _OP_GAS[_o] = 0
_OP_GAS[0xFF] = 0  # SELFDESTRUCT: dynamic at site

_PRECOMPILE_ADDRS = frozenset(
    "0x" + hex(i)[2:].rjust(40, "0") for i in range(1, 10)
)


class EVM:
    def __init__(self, state: WorldState, ctx: Optional[BlockCtx] = None):
        self.state = state
        self.ctx = ctx or BlockCtx()
        self.logs: List[Log] = []
        # EIP-1153 transient storage: per-address word map, cleared at
        # tx start, reverted with the state on frame revert
        self.transient: Dict[str, Dict[int, int]] = {}
        # EIP-2929 per-tx access sets (revert-scoped) + EIP-2200 original
        # storage values + EIP-3529 refund counter
        self._warm_addrs: set = set()
        self._warm_slots: set = set()
        self._orig_storage: Dict[tuple, int] = {}
        self._refund: int = 0
        # EIP-6780: SELFDESTRUCT deletes only accounts created in the
        # SAME transaction; both sets are revert-scoped with the frame
        self._created_this_tx: set = set()
        self._selfdestructed: set = set()
        # EIP-4844: the executing tx's blob versioned hashes (BLOBHASH)
        self._blob_hashes: List[int] = []
        # geth-callTracer-shaped call tree, recorded per transaction
        # (serves eigenrpc_traceTransaction — the reference STUBS that
        # method, custom_reth/eigen.rs:70-74; here it works)
        self._trace_stack: List[dict] = []
        self._trace_root: Optional[dict] = None

    # -- call tracing ------------------------------------------------------------

    def _trace_enter(self, typ: str, frm: str, to: Optional[str],
                     value: int, gas: int, data: bytes) -> dict:
        frame = {
            "type": typ, "from": frm, "to": to, "value": hex(value),
            "gas": hex(max(gas, 0)), "input": "0x" + data.hex(), "calls": [],
        }
        if self._trace_stack:
            self._trace_stack[-1]["calls"].append(frame)
        else:
            self._trace_root = frame
        self._trace_stack.append(frame)
        return frame

    def _trace_exit(self, frame: dict, gas_left: int, output: bytes = b"",
                    error: Optional[str] = None) -> None:
        frame["gasUsed"] = hex(max(int(frame["gas"], 16) - max(gas_left, 0), 0))
        frame["output"] = "0x" + output.hex()
        if error:
            frame["error"] = error
        if self._trace_stack and self._trace_stack[-1] is frame:
            self._trace_stack.pop()

    # -- world snapshot (accounts + transient storage) ---------------------------

    def _snapshot(self):
        return (
            self.state.snapshot(),
            {a: dict(m) for a, m in self.transient.items()},
            set(self._warm_addrs),
            set(self._warm_slots),
            self._refund,
            set(self._created_this_tx),
            set(self._selfdestructed),
        )

    def _restore(self, snap) -> None:
        self.state.restore(snap[0])
        self.transient = snap[1]
        # EIP-2929: access sets revert with the scope; refunds likewise
        self._warm_addrs = snap[2]
        self._warm_slots = snap[3]
        self._refund = snap[4]
        self._created_this_tx = snap[5]
        self._selfdestructed = snap[6]

    # -- EIP-2929 access accounting ---------------------------------------------

    def _access_account(self, addr: str) -> int:
        """Warm/cold account access cost; marks the address warm."""
        addr = addr.lower()
        if addr in self._warm_addrs or addr in _PRECOMPILE_ADDRS:
            return G_WARM_ACCESS
        self._warm_addrs.add(addr)
        return G_COLD_ACCOUNT

    def _access_slot(self, addr: str, key: int) -> int:
        """SLOAD cost under EIP-2929: 2100 cold / 100 warm; marks warm."""
        k = (addr.lower(), key)
        if k in self._warm_slots:
            return G_WARM_ACCESS
        self._warm_slots.add(k)
        return G_COLD_SLOAD

    def _slot_is_cold(self, addr: str, key: int) -> bool:
        k = (addr.lower(), key)
        if k in self._warm_slots:
            return False
        self._warm_slots.add(k)
        return True

    def _orig_value(self, addr: str, key: int) -> int:
        """Storage value at tx start (EIP-2200 'original')."""
        k = (addr.lower(), key)
        if k not in self._orig_storage:
            self._orig_storage[k] = self.state.get(addr).storage.get(key, 0)
        return self._orig_storage[k]

    # -- transaction entry -----------------------------------------------------

    def execute_tx(self, tx: dict, sender: str) -> dict:
        """Apply one transaction; returns a receipt dict.  State is rolled
        back on failure (except gas charge), mirroring revm's
        transact+commit semantics (custom_reth/mod.rs:604-640)."""
        sender = sender.lower()
        value = _hx(tx.get("value", 0))
        gas_limit = _hx(tx.get("gas", 1_000_000))
        data = _data_bytes(tx.get("input") or tx.get("data") or "0x")
        to = tx.get("to")
        is_create = to is None or to in ("", "0x")

        # --- effective gas price (EIP-1559): type-2 txs carry
        # maxFeePerGas/maxPriorityFeePerGas; legacy gasPrice must clear
        # the block base fee.  The base-fee portion is BURNED (never
        # credited to the coinbase); only the priority tip is paid out.
        basefee = self.ctx.basefee
        if tx.get("maxFeePerGas") is not None:
            max_fee = _hx(tx["maxFeePerGas"])
            max_prio = _hx(tx.get("maxPriorityFeePerGas", 0))
            if max_fee < basefee or max_prio > max_fee:
                return {"status": 0, "gasUsed": 0, "logs": [],
                        "error": "fee-cap-below-basefee"}
            gas_price = min(max_fee, basefee + max_prio)
        else:
            gas_price = _hx(tx.get("gasPrice", 0))
            if gas_price < basefee:
                return {"status": 0, "gasUsed": 0, "logs": [],
                        "error": "gasprice-below-basefee"}
        tip = gas_price - basefee

        # --- EIP-4844 blob gas: versioned-hash validity, blob fee cap vs
        # the block's blob base fee; the blob fee is charged at the BLOCK
        # rate and burned (never refunded, never to the coinbase)
        blob_hashes = [_hx(h) for h in (tx.get("blobVersionedHashes") or [])]
        blob_gas = len(blob_hashes) * GAS_PER_BLOB
        max_blob_fee = 0
        if blob_hashes:
            if is_create:
                return {"status": 0, "gasUsed": 0, "logs": [],
                        "error": "blob-tx-create"}
            if any((h >> 248) != 0x01 for h in blob_hashes):
                return {"status": 0, "gasUsed": 0, "logs": [],
                        "error": "blob-hash-version"}
            max_blob_fee = _hx(tx.get("maxFeePerBlobGas", 0))
            if max_blob_fee < self.ctx.blob_basefee:
                return {"status": 0, "gasUsed": 0, "logs": [],
                        "error": "blob-fee-cap-below-basefee"}

        # --- intrinsic gas: 21000 + EIP-2028 calldata + EIP-2930 access
        # list + CREATE surcharge with EIP-3860 initcode words
        zeros = data.count(0)
        intrinsic = (INTRINSIC_GAS + G_TXDATA_ZERO * zeros
                     + G_TXDATA_NONZERO * (len(data) - zeros))
        access_list = tx.get("accessList") or []
        for ent in access_list:
            intrinsic += G_ACCESSLIST_ADDR
            intrinsic += G_ACCESSLIST_KEY * len(ent.get("storageKeys") or [])
        if is_create:
            intrinsic += CREATE_GAS
            intrinsic += G_INITCODE_WORD * ((len(data) + 31) // 32)
        s_acc = self.state.touch(sender, fund=True)
        # nonce discipline (revm enforces this in the reference's loop,
        # custom_reth/mod.rs:604-640): a tx carrying a nonce must match
        # the account nonce exactly — stale nonces are replays, future
        # nonces must wait.  Txs without a nonce field (dev tooling)
        # implicitly use the account nonce.
        if tx.get("nonce") is not None:
            want = _hx(tx["nonce"])
            if want != s_acc.nonce:
                return {
                    "status": 0,
                    "gasUsed": 0,
                    "logs": [],
                    "error": "nonce-stale" if want < s_acc.nonce else "nonce-future",
                }
        upfront = value + gas_limit * gas_price + blob_gas * max_blob_fee
        if s_acc.balance < upfront or gas_limit < intrinsic:
            return {"status": 0, "gasUsed": 0, "logs": [], "error": "prefund"}
        self.transient = {}  # EIP-1153: cleared at transaction start
        # per-tx access bookkeeping: pre-warm sender, target, coinbase
        # (EIP-3651) and every access-list entry (EIP-2930)
        self._warm_addrs = {sender, self.ctx.coinbase.lower()}
        self._warm_slots = set()
        self._orig_storage = {}
        self._refund = 0
        self._created_this_tx = set()
        self._selfdestructed = set()
        self._blob_hashes = [
            _hx(h) for h in (tx.get("blobVersionedHashes") or [])
        ]
        if not is_create:
            self._warm_addrs.add(to.lower())
        for ent in access_list:
            a = (ent.get("address") or "0x").lower()
            self._warm_addrs.add(a)
            for k in ent.get("storageKeys") or []:
                self._warm_slots.add((a, _hx(k)))
        snap = self._snapshot()
        logs_mark = len(self.logs)
        self._trace_stack = []
        self._trace_root = None
        s_acc.balance -= gas_limit * gas_price
        # EIP-4844: burn the blob fee up front at the block's blob base
        # fee; it is NOT refundable and not part of the revert re-apply
        # (the revert path restores the snapshot taken AFTER this charge)
        s_acc.balance -= blob_gas * self.ctx.blob_basefee
        s_acc.nonce += 1
        gas = gas_limit - intrinsic
        contract_address = None
        try:
            if is_create:
                contract_address, gas = self._create(
                    sender, value, data, gas, depth=0, origin=sender
                )
                status = 1
            else:
                _, gas = self._call(sender, to.lower(), value, data, gas, 0,
                                    origin=sender)
                status = 1
        except (_Revert, _Halt) as e:
            self._restore(snap)
            del self.logs[logs_mark:]
            # re-apply the irreversible parts: nonce bump + gas charge
            s_acc = self.state.touch(sender)
            s_acc.nonce += 1
            s_acc.balance -= gas_limit * gas_price
            s_acc.balance -= blob_gas * self.ctx.blob_basefee  # EIP-4844 burn
            # REVERT returns the remaining gas; a halt consumes it all
            gas = e.gas_left if isinstance(e, _Revert) else 0
            status = 0
        gas_used = gas_limit - gas
        if status:  # EIP-3529: refund only on success, capped at used/5
            gas_used -= min(max(self._refund, 0),
                            gas_used // MAX_REFUND_QUOTIENT)
            gas = gas_limit - gas_used
        # EIP-6780: accounts self-destructed in the tx that created them
        # are deleted at end of transaction (code, storage, nonce, and
        # any balance received after the sweep are gone)
        if status:
            for a in self._selfdestructed:
                self.state.accounts.pop(a.lower(), None)
        self._selfdestructed = set()
        self._created_this_tx = set()
        # refund unused gas at the effective price; the coinbase receives
        # only the PRIORITY portion — the base-fee part is burned
        s_acc = self.state.touch(sender)
        s_acc.balance += gas * gas_price
        if tip:
            self.state.touch(self.ctx.coinbase).balance += gas_used * tip
        out = {
            "status": status,
            "gasUsed": gas_used,
            "logs": self.logs[logs_mark:],
            "contractAddress": contract_address,
            "trace": self._trace_root,
        }
        if blob_gas:
            out["blobGasUsed"] = blob_gas
            out["blobGasPrice"] = self.ctx.blob_basefee
        return out

    def call_view(self, tx: dict) -> bytes:
        """eth_call semantics: run against current state, discard every
        state change, return the call's output bytes.  Raises ValueError
        on revert (carrying the revert data) or halt."""
        sender = (tx.get("from") or "0x" + "00" * 20).lower()
        to = tx.get("to")
        if to is None or to in ("", "0x"):
            raise ValueError("eth_call requires 'to'")
        value = _hx(tx.get("value", 0))
        gas = _hx(tx.get("gas", 10_000_000))
        data = _data_bytes(tx.get("input") or tx.get("data") or "0x")
        self.transient = {}
        snap = self._snapshot()
        logs_mark = len(self.logs)
        try:
            self.state.touch(sender, fund=True)  # discarded with the snapshot
            ret, _ = self._call(sender, to.lower(), value, data, gas, 0,
                                origin=sender)
            return ret
        except _Revert as r:
            raise ValueError("execution reverted: 0x" + r.data.hex())
        except _Halt:
            raise ValueError("execution failed")
        finally:
            self._restore(snap)
            del self.logs[logs_mark:]

    def estimate_gas(self, tx: dict) -> int:
        """eth_estimateGas semantics: execute the transaction against a
        snapshot with a generous gas limit and zero gas price, discard
        every state change, return the gas it used."""
        sender = (tx.get("from") or "0x" + "00" * 20).lower()
        t = dict(tx)
        t.setdefault("gas", hex(self.ctx.gas_limit or 30_000_000))
        t["gasPrice"] = hex(self.ctx.basefee)  # zero tip; clears the 1559 floor
        t.pop("maxFeePerGas", None)
        t.pop("maxPriorityFeePerGas", None)
        snap = self._snapshot()
        logs_mark = len(self.logs)
        try:
            r = self.execute_tx(t, sender)
        finally:
            self._restore(snap)
            del self.logs[logs_mark:]
        if r["status"] != 1:
            raise ValueError(r.get("error") or "execution reverted")
        return int(r["gasUsed"])

    # -- calls -----------------------------------------------------------------

    def _transfer(self, frm: str, to: str, value: int) -> None:
        if value == 0:
            return
        a, b = self.state.touch(frm), self.state.touch(to)
        if a.balance < value:
            raise _Halt()
        a.balance -= value
        b.balance += value

    def _create(self, sender: str, value: int, init: bytes, gas: int,
                depth: int, salt: Optional[int] = None,
                origin: Optional[str] = None):
        frame = self._trace_enter(
            "CREATE2" if salt is not None else "CREATE",
            sender, None, value, gas, init,
        )
        try:
            addr, rem = self._create_impl(sender, value, init, gas, depth,
                                          salt=salt, origin=origin)
        except _Revert as e:
            self._trace_exit(frame, 0, e.data, "execution reverted")
            raise
        except _Halt:
            self._trace_exit(frame, 0, b"", "out of gas or invalid operation")
            raise
        frame["to"] = addr
        self._trace_exit(frame, rem, self.state.get(addr).code)
        return addr, rem

    def _create_impl(self, sender: str, value: int, init: bytes, gas: int,
                     depth: int, salt: Optional[int] = None,
                     origin: Optional[str] = None):
        if depth > MAX_DEPTH:
            raise _Halt()
        if salt is not None:  # CREATE2 address rule (EIP-1014)
            addr = "0x" + keccak.keccak256_host(
                b"\xff" + _addr_bytes(sender) + salt.to_bytes(32, "big")
                + keccak.keccak256_host(init)
            )[12:].hex()
        else:
            nonce_used = self.state.get(sender).nonce - (1 if depth == 0 else 0)
            addr = "0x" + keccak.keccak256_host(
                rlp.encode([_addr_bytes(sender), rlp.encode_int(nonce_used)])
            )[12:].hex()
        if depth > 0:
            self.state.touch(sender).nonce += 1
        self._warm_addrs.add(addr)  # EIP-2929: created address is warm
        self._created_this_tx.add(addr)  # EIP-6780 same-tx creation set
        self._transfer(sender, addr, value)
        code, gas = self._run(addr, sender, value, init, b"", gas, depth,
                              init_code=True, origin=origin)
        # code-deposit charge (200/byte) + EIP-170 size cap + EIP-3541
        # (no code starting with 0xEF)
        deposit = G_CODEDEPOSIT * len(code)
        if gas < deposit or len(code) > 24_576 or code[:1] == b"\xef":
            raise _Halt()
        gas -= deposit
        self.state.touch(addr).code = code
        return addr, gas

    def _call(
        self, sender: str, to: str, value: int, data: bytes, gas: int, depth: int,
        code_addr: Optional[str] = None, static: bool = False,
        origin: Optional[str] = None,
    ):
        frame = self._trace_enter(
            "STATICCALL" if static else "CALL", sender, to, value, gas, data
        )
        try:
            ret, rem = self._call_impl(sender, to, value, data, gas, depth,
                                       code_addr=code_addr, static=static,
                                       origin=origin)
        except _Revert as e:
            self._trace_exit(frame, 0, e.data, "execution reverted")
            raise
        except _Halt:
            self._trace_exit(frame, 0, b"", "out of gas or invalid operation")
            raise
        self._trace_exit(frame, rem, ret)
        return ret, rem

    def _call_impl(
        self, sender: str, to: str, value: int, data: bytes, gas: int, depth: int,
        code_addr: Optional[str] = None, static: bool = False,
        origin: Optional[str] = None,
    ):
        if depth > MAX_DEPTH:
            raise _Halt()
        self._transfer(sender, to, value)
        pre = _precompile(to, data, gas)
        if pre is not None:
            return pre
        code = self.state.get(code_addr or to).code
        if not code:
            return b"", gas
        return self._run(to, sender, value, code, data, gas, depth,
                         static=static, origin=origin)

    # -- the interpreter ---------------------------------------------------------

    def _run(
        self, self_addr: str, caller: str, callvalue: int, code: bytes,
        calldata: bytes, gas: int, depth: int, init_code: bool = False,
        static: bool = False, origin: Optional[str] = None,
    ) -> Tuple[bytes, int]:
        origin = origin or caller
        stack: List[int] = []
        mem = bytearray()
        ret_data = b""
        acc = self.state.touch(self_addr)
        pc = 0
        jumpdests = _jumpdests(code)
        gas_left = gas

        def use(g):
            nonlocal gas_left
            gas_left -= g
            if gas_left < 0:
                raise _Halt()

        def _mcost(words: int) -> int:
            # quadratic memory expansion: 3w + floor(w^2 / 512)
            return G_MEMWORD * words + words * words // 512

        def mexpand(off, size):
            if size == 0:
                return
            need = off + size
            if need > len(mem):
                new_words = (need + 31) // 32
                use(_mcost(new_words) - _mcost(len(mem) // 32))
                mem.extend(b"\x00" * (new_words * 32 - len(mem)))

        def push(v):
            if len(stack) >= 1024:
                raise _Halt()
            stack.append(v & U256)

        def pop():
            if not stack:
                raise _Halt()
            return stack.pop()

        while pc < len(code):
            op = code[pc]
            pc += 1
            use(_OP_GAS.get(op, 0))  # static base; dynamic parts at sites
            if op == 0x00:  # STOP
                return (b"", gas_left)
            elif 0x01 <= op <= 0x0B:  # arithmetic
                a = pop()
                if op == 0x01: push(a + pop())
                elif op == 0x02: push(a * pop())
                elif op == 0x03: push(a - pop())
                elif op == 0x04:
                    b = pop(); push(a // b if b else 0)
                elif op == 0x05:
                    b = pop(); push(_sdiv(a, b))
                elif op == 0x06:
                    b = pop(); push(a % b if b else 0)
                elif op == 0x07:
                    b = pop(); push(_smod(a, b))
                elif op == 0x08:
                    b, n = pop(), pop(); push((a + b) % n if n else 0)
                elif op == 0x09:
                    b, n = pop(), pop(); push((a * b) % n if n else 0)
                elif op == 0x0A:
                    e = pop(); use(G_EXPBYTE * ((e.bit_length() + 7) // 8))
                    push(pow(a, e, 1 << 256))
                elif op == 0x0B:  # SIGNEXTEND
                    x = pop(); push(_signextend(a, x))
            elif 0x10 <= op <= 0x1D:  # comparison / bitwise
                if op == 0x15:  # ISZERO
                    push(1 if pop() == 0 else 0)
                elif op == 0x19:  # NOT
                    push(~pop())
                else:
                    a, b = pop(), pop()
                    if op == 0x10: push(1 if a < b else 0)
                    elif op == 0x11: push(1 if a > b else 0)
                    elif op == 0x12: push(1 if _sint(a) < _sint(b) else 0)
                    elif op == 0x13: push(1 if _sint(a) > _sint(b) else 0)
                    elif op == 0x14: push(1 if a == b else 0)
                    elif op == 0x16: push(a & b)
                    elif op == 0x17: push(a | b)
                    elif op == 0x18: push(a ^ b)
                    elif op == 0x1A:  # BYTE
                        push((b >> (8 * (31 - a))) & 0xFF if a < 32 else 0)
                    elif op == 0x1B: push(b << a if a < 256 else 0)
                    elif op == 0x1C: push(b >> a if a < 256 else 0)
                    elif op == 0x1D:  # SAR
                        push(_sar(a, b))
            elif op == 0x20:  # SHA3
                off, size = pop(), pop()
                mexpand(off, size)
                use(G_SHA3WORD * ((size + 31) // 32))
                push(int.from_bytes(
                    keccak.keccak256_host(bytes(mem[off : off + size])), "big"))
            elif op == 0x30: push(int(self_addr, 16))
            elif op == 0x31:  # BALANCE (EIP-2929 account access)
                a = _to_addr(pop())
                use(self._access_account(a))
                push(self.state.get(a).balance)
            elif op == 0x32: push(int(origin, 16))
            elif op == 0x33: push(int(caller, 16))
            elif op == 0x34: push(callvalue)
            elif op == 0x35:  # CALLDATALOAD
                off = pop()
                push(int.from_bytes(calldata[off : off + 32].ljust(32, b"\x00"), "big"))
            elif op == 0x36: push(len(calldata))
            elif op == 0x37:  # CALLDATACOPY
                d, s, n = pop(), pop(), pop()
                mexpand(d, n); use(G_COPYWORD * ((n + 31) // 32))
                mem[d : d + n] = calldata[s : s + n].ljust(n, b"\x00")
            elif op == 0x38: push(len(code))
            elif op == 0x39:  # CODECOPY
                d, s, n = pop(), pop(), pop()
                mexpand(d, n); use(G_COPYWORD * ((n + 31) // 32))
                mem[d : d + n] = code[s : s + n].ljust(n, b"\x00")
            elif op == 0x3A: push(0)  # GASPRICE (metered at tx level)
            elif op == 0x3B:  # EXTCODESIZE
                a = _to_addr(pop())
                use(self._access_account(a))
                push(len(self.state.get(a).code))
            elif op == 0x3C:  # EXTCODECOPY
                a, d, s, n = pop(), pop(), pop(), pop()
                aa = _to_addr(a)
                use(self._access_account(aa))
                c = self.state.get(aa).code
                mexpand(d, n); use(G_COPYWORD * ((n + 31) // 32))
                mem[d : d + n] = c[s : s + n].ljust(n, b"\x00")
            elif op == 0x3D: push(len(ret_data))
            elif op == 0x3E:  # RETURNDATACOPY
                d, s, n = pop(), pop(), pop()
                if s + n > len(ret_data):
                    raise _Halt()
                mexpand(d, n)
                mem[d : d + n] = ret_data[s : s + n]
            elif op == 0x3F:  # EXTCODEHASH
                a = _to_addr(pop())
                use(self._access_account(a))
                push(int.from_bytes(
                    keccak.keccak256_host(self.state.get(a).code), "big"))
            elif op == 0x40:  # BLOCKHASH: last-256 canonical lookup
                bn = pop()
                h = 0
                if (self.ctx.block_hash_fn is not None
                        and bn < self.ctx.number
                        and self.ctx.number - bn <= 256):
                    h = int(self.ctx.block_hash_fn(bn) or 0)
                push(h)
            elif op == 0x41: push(int(self.ctx.coinbase, 16))
            elif op == 0x42: push(self.ctx.timestamp)
            elif op == 0x43: push(self.ctx.number)
            elif op == 0x44: push(self.ctx.prevrandao)
            elif op == 0x45: push(self.ctx.gas_limit)
            elif op == 0x46: push(self.ctx.chain_id)
            elif op == 0x47: push(acc.balance)
            elif op == 0x48: push(self.ctx.basefee)
            elif op == 0x49:  # BLOBHASH (EIP-4844): tx versioned hashes
                i = pop()
                push(self._blob_hashes[i] if i < len(self._blob_hashes) else 0)
            elif op == 0x4A: push(self.ctx.blob_basefee)  # BLOBBASEFEE
            elif op == 0x50: pop()
            elif op == 0x51:  # MLOAD
                off = pop(); mexpand(off, 32)
                push(int.from_bytes(mem[off : off + 32], "big"))
            elif op == 0x52:  # MSTORE
                off, v = pop(), pop(); mexpand(off, 32)
                mem[off : off + 32] = v.to_bytes(32, "big")
            elif op == 0x53:  # MSTORE8
                off, v = pop(), pop(); mexpand(off, 1)
                mem[off] = v & 0xFF
            elif op == 0x54:  # SLOAD (EIP-2929 warm/cold)
                k = pop()
                use(self._access_slot(self_addr, k))
                push(acc.storage.get(k, 0))
            elif op == 0x55:  # SSTORE (EIP-2200 + EIP-2929 + EIP-3529)
                if static:
                    raise _Halt()
                if gas_left <= G_SSTORE_SENTRY:
                    raise _Halt()
                k, v = pop(), pop()
                cost = G_COLD_SLOAD if self._slot_is_cold(self_addr, k) else 0
                cur = acc.storage.get(k, 0)
                orig = self._orig_value(self_addr, k)
                if cur == v:
                    cost += G_WARM_ACCESS
                elif cur == orig:
                    cost += G_SSTORE_SET if orig == 0 else G_SSTORE_RESET
                    if orig != 0 and v == 0:
                        self._refund += R_SCLEAR
                else:  # dirty slot
                    cost += G_WARM_ACCESS
                    if orig != 0:
                        if cur == 0:
                            self._refund -= R_SCLEAR
                        elif v == 0:
                            self._refund += R_SCLEAR
                    if v == orig:
                        self._refund += (
                            G_SSTORE_SET - G_WARM_ACCESS
                            if orig == 0
                            else G_SSTORE_RESET - G_WARM_ACCESS
                        )
                use(cost)
                if v:
                    acc.storage[k] = v
                else:
                    acc.storage.pop(k, None)
            elif op == 0x56:  # JUMP
                pc = pop()
                if pc not in jumpdests:
                    raise _Halt()
            elif op == 0x57:  # JUMPI
                d, c = pop(), pop()
                if c:
                    pc = d
                    if pc not in jumpdests:
                        raise _Halt()
            elif op == 0x58: push(pc - 1)
            elif op == 0x59: push(len(mem))
            elif op == 0x5A: push(gas_left)
            elif op == 0x5B: pass  # JUMPDEST
            elif op == 0x5C:  # TLOAD (EIP-1153; warm-access base from table)
                push(self.transient.get(self_addr, {}).get(pop(), 0))
            elif op == 0x5D:  # TSTORE
                if static:
                    raise _Halt()
                k, v = pop(), pop()
                self.transient.setdefault(self_addr, {})[k] = v
            elif op == 0x5E:  # MCOPY (EIP-5656)
                dst, src, ln = pop(), pop(), pop()
                mexpand(src, ln)
                mexpand(dst, ln)
                use(G_COPYWORD * ((ln + 31) // 32))
                mem[dst : dst + ln] = bytes(mem[src : src + ln])
            elif op == 0x5F: push(0)  # PUSH0
            elif 0x60 <= op <= 0x7F:  # PUSHn
                n = op - 0x5F
                push(int.from_bytes(code[pc : pc + n].ljust(n, b"\x00"), "big"))
                pc += n
            elif 0x80 <= op <= 0x8F:  # DUPn
                n = op - 0x7F
                if len(stack) < n:
                    raise _Halt()
                push(stack[-n])
            elif 0x90 <= op <= 0x9F:  # SWAPn
                n = op - 0x8F
                if len(stack) < n + 1:
                    raise _Halt()
                stack[-1], stack[-n - 1] = stack[-n - 1], stack[-1]
            elif 0xA0 <= op <= 0xA4:  # LOGn
                if static:
                    raise _Halt()
                n = op - 0xA0
                off, size = pop(), pop()
                topics = [pop() for _ in range(n)]
                mexpand(off, size)
                use(G_LOG + G_LOGTOPIC * n + G_LOGDATA * size)
                self.logs.append(Log(self_addr, topics, bytes(mem[off : off + size])))
            elif op in (0xF0, 0xF5):  # CREATE / CREATE2
                if static:
                    raise _Halt()
                use(CREATE_GAS)
                v, off, size = pop(), pop(), pop()
                salt = pop() if op == 0xF5 else None
                mexpand(off, size)
                init_words = (size + 31) // 32
                use(G_INITCODE_WORD * init_words)  # EIP-3860
                if op == 0xF5:  # CREATE2 hashes the init code
                    use(G_SHA3WORD * init_words)
                sub_gas = gas_left - gas_left // 64  # EIP-150
                csnap = self._snapshot()
                cmarks = len(self.logs)
                try:
                    addr, rem = self._create(
                        self_addr, v, bytes(mem[off : off + size]), sub_gas,
                        depth + 1, salt=salt, origin=origin,
                    )
                    gas_left = gas_left - sub_gas + rem
                    push(int(addr, 16))
                    ret_data = b""
                except _Revert as e:
                    # reverting init code rolls back the value transfer,
                    # nonce bump and any state it wrote; remaining gas
                    # returns to the creator
                    self._restore(csnap)
                    del self.logs[cmarks:]
                    gas_left = gas_left - sub_gas + e.gas_left
                    push(0); ret_data = e.data
                except _Halt:
                    self._restore(csnap)
                    del self.logs[cmarks:]
                    gas_left = gas_left - sub_gas
                    push(0); ret_data = b""
            elif op in (0xF1, 0xF4, 0xFA):  # CALL / DELEGATECALL / STATICCALL
                g = pop()
                a = _to_addr(pop())
                use(self._access_account(a))  # EIP-2929
                v = pop() if op == 0xF1 else 0
                if static and v:
                    raise _Halt()  # no value transfer in a static context
                stipend = 0
                if v:
                    use(G_CALLVALUE)
                    stipend = G_CALLSTIPEND
                    tgt = self.state.get(a)
                    if (tgt.nonce == 0 and tgt.balance == 0 and not tgt.code
                            and a not in _PRECOMPILE_ADDRS):
                        use(G_NEWACCOUNT)
                ioff, isz, ooff, osz = pop(), pop(), pop(), pop()
                mexpand(ioff, isz)
                mexpand(ooff, osz)
                sub_gas = min(g, gas_left - gas_left // 64)
                args = bytes(mem[ioff : ioff + isz])
                snap = self._snapshot()
                marks = len(self.logs)
                try:
                    if op == 0xF1:
                        out, rem = self._call(
                            self_addr, a, v, args, sub_gas + stipend, depth + 1,
                            static=static, origin=origin,
                        )
                    elif op == 0xF4:  # DELEGATECALL: run a's code in our ctx
                        codea = self.state.get(a).code
                        dframe = self._trace_enter(
                            "DELEGATECALL", self_addr, a, 0, sub_gas, args
                        )
                        try:
                            out, rem = self._run(
                                self_addr, caller, callvalue, codea, args,
                                sub_gas, depth + 1, static=static,
                                origin=origin,
                            ) if codea else (b"", sub_gas)
                        except _Revert as e:
                            self._trace_exit(dframe, 0, e.data,
                                             "execution reverted")
                            raise
                        except _Halt:
                            self._trace_exit(dframe, 0, b"",
                                             "out of gas or invalid operation")
                            raise
                        self._trace_exit(dframe, rem, out)
                    else:  # STATICCALL
                        out, rem = self._call(
                            self_addr, a, 0, args, sub_gas, depth + 1,
                            static=True, origin=origin,
                        )
                    gas_left = gas_left - sub_gas + rem
                    ret_data = out
                    mem[ooff : ooff + osz] = out[:osz].ljust(osz, b"\x00")
                    push(1)
                except _Revert as e:
                    self._restore(snap)
                    del self.logs[marks:]
                    ret_data = e.data
                    mem[ooff : ooff + osz] = e.data[:osz].ljust(osz, b"\x00")
                    # REVERT hands back the callee's remaining gas
                    gas_left = gas_left - sub_gas + e.gas_left
                    push(0)
                except _Halt:
                    self._restore(snap)
                    del self.logs[marks:]
                    ret_data = b""
                    gas_left = gas_left - sub_gas
                    push(0)
            elif op == 0xF3:  # RETURN
                off, size = pop(), pop()
                mexpand(off, size)
                return (bytes(mem[off : off + size]), gas_left)
            elif op == 0xFD:  # REVERT
                off, size = pop(), pop()
                mexpand(off, size)
                raise _Revert(bytes(mem[off : off + size]), gas_left)
            elif op == 0xFF:  # SELFDESTRUCT (EIP-6780-style: sweep only)
                if static:
                    raise _Halt()
                ben = _to_addr(pop())
                cost = G_SELFDESTRUCT
                if ben not in self._warm_addrs and ben not in _PRECOMPILE_ADDRS:
                    self._warm_addrs.add(ben)
                    cost += G_COLD_ACCOUNT
                tgt = self.state.get(ben)
                if (acc.balance and tgt.nonce == 0 and tgt.balance == 0
                        and not tgt.code):
                    cost += G_NEWACCOUNT
                use(cost)
                self.state.touch(ben).balance += acc.balance
                acc.balance = 0
                # EIP-6780: deletion ONLY if this account was created in
                # the same transaction (scheduled; applied at tx end).
                # Self-beneficiary then burns the swept balance with it.
                if self_addr in self._created_this_tx:
                    self._selfdestructed.add(self_addr)
                return (b"", gas_left)
            else:  # INVALID / unsupported
                raise _Halt()
        return (b"", gas_left)


# blake2b constants for the 0x09 blake2f compression precompile (EIP-152)
_B2_IV = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)
_B2_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)
_U64 = (1 << 64) - 1


def _blake2f_compress(rounds: int, h, m, t0, t1, final: bool):
    v = list(h) + list(_B2_IV)
    v[12] ^= t0
    v[13] ^= t1
    if final:
        v[14] ^= _U64

    def rotr(x, n):
        return ((x >> n) | (x << (64 - n))) & _U64

    def g(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & _U64
        v[d] = rotr(v[d] ^ v[a], 32)
        v[c] = (v[c] + v[d]) & _U64
        v[b] = rotr(v[b] ^ v[c], 24)
        v[a] = (v[a] + v[b] + y) & _U64
        v[d] = rotr(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & _U64
        v[b] = rotr(v[b] ^ v[c], 63)

    for i in range(rounds):
        s = _B2_SIGMA[i % 10]
        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def _bn254_g1_parse(buf: bytes, off: int):
    """Parse an EIP-196 G1 point (two 32-byte big-endian Fq words);
    (0,0) is infinity; out-of-field or off-curve input is an error."""
    from ..ops import bn254

    x = int.from_bytes(buf[off : off + 32], "big")
    y = int.from_bytes(buf[off + 32 : off + 64], "big")
    if x >= bn254.Q or y >= bn254.Q:
        raise _Halt()
    if x == 0 and y == 0:
        return None
    p = (x, y)
    if not bn254.h_on_curve_g1(p):
        raise _Halt()
    return p


def _bn254_g2_parse(buf: bytes, off: int):
    """EIP-197 G2 encoding: each Fq2 coordinate is (imaginary, real) —
    a·i + b serialized as (a, b).  Requires on-curve AND r-torsion
    membership ([r-1]Q == -Q), as the pairing precompile must."""
    from ..ops import bn254

    xi = int.from_bytes(buf[off : off + 32], "big")
    xr = int.from_bytes(buf[off + 32 : off + 64], "big")
    yi = int.from_bytes(buf[off + 64 : off + 96], "big")
    yr = int.from_bytes(buf[off + 96 : off + 128], "big")
    if max(xi, xr, yi, yr) >= bn254.Q:
        raise _Halt()
    if xi == xr == yi == yr == 0:
        return None
    q2 = ((xr, xi), (yr, yi))
    if not bn254.h_on_curve_g2(q2):
        raise _Halt()
    end = bn254.h_ec_mul_jac_f(bn254.R - 1, q2, bn254.HOST_FQ2)
    neg = (q2[0], ((-q2[1][0]) % bn254.Q, (-q2[1][1]) % bn254.Q))
    if end != neg:
        raise _Halt()
    return q2


def _modexp_gas(bsize: int, esize: int, msize: int, e_head: int) -> int:
    """EIP-2565 pricing: multiplication complexity × iteration count / 3."""
    words = (max(bsize, msize) + 7) // 8
    mult = words * words
    if esize <= 32:
        it = e_head.bit_length() - 1 if e_head else 0
    else:
        it = 8 * (esize - 32) + (e_head.bit_length() - 1 if e_head else 0)
    return max(200, mult * max(it, 1) // 3)


def _precompile(to: str, data: bytes, gas: int) -> Optional[Tuple[bytes, int]]:
    """The Ethereum precompile set 0x01-0x09 (the role revm's precompile
    registry fills inside the reference's payload builder,
    src/custom_reth/mod.rs:604-613): ecrecover, sha256, ripemd160,
    identity, modexp (EIP-198/2565), BN254 ecadd/ecmul (EIP-196),
    BN254 pairing check (EIP-197), blake2f (EIP-152).  The BN254 trio
    reuses this framework's own prover curve ops (ops/bn254.py,
    ops/pairing.py), so the L2 EVM can verify the Groth16 proofs this
    framework emits on-chain.  Returns (return_data, gas_left) or None
    when `to` is not a precompile; raises _Halt on invalid input / OOG
    (the caller's CALL handler turns that into push-0 failure)."""
    n = int(to, 16)
    if not 1 <= n <= 9:
        return None

    def use(cost: int) -> int:
        if gas < cost:
            raise _Halt()
        return gas - cost

    words = (len(data) + 31) // 32
    if n == 1:  # ecrecover
        from ..utils.secp256k1 import recover_address

        rem = use(3000)
        buf = data.ljust(128, b"\x00")[:128]
        h = buf[0:32]
        v = int.from_bytes(buf[32:64], "big")
        r = int.from_bytes(buf[64:96], "big")
        s = int.from_bytes(buf[96:128], "big")
        if v not in (27, 28):
            return b"", rem
        try:
            addr = recover_address(h, v - 27, r, s)
        except Exception:
            return b"", rem
        if addr is None:
            return b"", rem
        return bytes(12) + bytes.fromhex(addr[2:]), rem
    if n == 2:  # sha256
        import hashlib

        rem = use(60 + 12 * words)
        return hashlib.sha256(data).digest(), rem
    if n == 3:  # ripemd160
        import hashlib

        rem = use(600 + 120 * words)
        d = hashlib.new("ripemd160", data).digest()
        return bytes(12) + d, rem
    if n == 4:  # identity
        return bytes(data), use(15 + 3 * words)
    if n == 5:  # modexp
        buf = data.ljust(96, b"\x00")
        bsize = int.from_bytes(buf[0:32], "big")
        esize = int.from_bytes(buf[32:64], "big")
        msize = int.from_bytes(buf[64:96], "big")
        if max(bsize, esize, msize) > 1 << 20:  # sanity bound
            raise _Halt()
        body = data[96:].ljust(bsize + esize + msize, b"\x00")
        e_bytes = body[bsize : bsize + esize]
        e_head = int.from_bytes(e_bytes[:32], "big")
        rem = use(_modexp_gas(bsize, esize, msize, e_head))
        if msize == 0:
            return b"", rem
        b = int.from_bytes(body[:bsize], "big")
        e = int.from_bytes(e_bytes, "big")
        m = int.from_bytes(body[bsize + esize : bsize + esize + msize], "big")
        out = pow(b, e, m) if m else 0
        return out.to_bytes(msize, "big"), rem
    if n == 6:  # BN254 add (EIP-196; 150 gas per EIP-1108)
        from ..ops import bn254

        rem = use(150)
        buf = data.ljust(128, b"\x00")[:128]
        p = _bn254_g1_parse(buf, 0)
        q = _bn254_g1_parse(buf, 64)
        s = bn254.h_ec_add(p, q)
        if s is None:
            return bytes(64), rem
        return s[0].to_bytes(32, "big") + s[1].to_bytes(32, "big"), rem
    if n == 7:  # BN254 scalar mul (EIP-196; 6000 gas per EIP-1108)
        from ..ops import bn254

        rem = use(6000)
        buf = data.ljust(96, b"\x00")[:96]
        p = _bn254_g1_parse(buf, 0)
        k = int.from_bytes(buf[64:96], "big")
        s = bn254.h_ec_mul_jac_f(k, p) if p is not None else None
        if s is None:
            return bytes(64), rem
        return s[0].to_bytes(32, "big") + s[1].to_bytes(32, "big"), rem
    if n == 8:  # BN254 pairing check (EIP-197; 45000 + 34000/pair)
        from ..ops import pairing as pr

        if len(data) % 192:
            raise _Halt()
        k = len(data) // 192
        rem = use(45000 + 34000 * k)
        f = pr.F12_ONE
        for i in range(k):
            p = _bn254_g1_parse(data, 192 * i)
            q2 = _bn254_g2_parse(data, 192 * i + 64)
            if p is None or q2 is None:
                continue
            f = pr.f12_mul(f, pr.miller_loop(p, q2))
        ok = pr.final_exponentiation(f) == pr.F12_ONE
        return int(ok).to_bytes(32, "big"), rem
    if n == 9:  # blake2f (EIP-152)
        if len(data) != 213 or data[212] not in (0, 1):
            raise _Halt()
        rounds = int.from_bytes(data[0:4], "big")
        rem = use(max(rounds, 1))
        h = [int.from_bytes(data[4 + 8 * i : 12 + 8 * i], "little") for i in range(8)]
        m = [int.from_bytes(data[68 + 8 * i : 76 + 8 * i], "little") for i in range(16)]
        t0 = int.from_bytes(data[196:204], "little")
        t1 = int.from_bytes(data[204:212], "little")
        out = _blake2f_compress(rounds, h, m, t0, t1, data[212] == 1)
        return b"".join(x.to_bytes(8, "little") for x in out), rem
    return None


def _hx(v) -> int:
    if isinstance(v, str):
        return int(v, 16) if v.startswith("0x") else int(v)
    return int(v)


def _data_bytes(d: str) -> bytes:
    if isinstance(d, (bytes, bytearray)):
        return bytes(d)
    h = d[2:] if d.startswith("0x") else d
    return bytes.fromhex(h) if h else b""


def _jumpdests(code: bytes) -> set:
    out = set()
    pc = 0
    while pc < len(code):
        op = code[pc]
        if op == 0x5B:
            out.add(pc)
        pc += (op - 0x5E) if 0x60 <= op <= 0x7F else 1
    return out


def _sint(a: int) -> int:
    return a - (1 << 256) if a & SIGN_BIT else a


def _sdiv(a: int, b: int) -> int:
    if b == 0:
        return 0
    sa, sb = _sint(a), _sint(b)
    q = abs(sa) // abs(sb)
    return (q if (sa < 0) == (sb < 0) else -q) & U256


def _smod(a: int, b: int) -> int:
    if b == 0:
        return 0
    sa, sb = _sint(a), _sint(b)
    r = abs(sa) % abs(sb)
    return (r if sa >= 0 else -r) & U256


def _sar(shift: int, v: int) -> int:
    s = _sint(v)
    if shift >= 256:
        return U256 if s < 0 else 0
    return (s >> shift) & U256


def _signextend(k: int, x: int) -> int:
    if k >= 31:
        return x
    bit = 8 * (k + 1) - 1
    if x & (1 << bit):
        return x | (U256 ^ ((1 << (bit + 1)) - 1))
    return x & ((1 << (bit + 1)) - 1)
