"""In-process L2 chain: mempool, tx filter, payload builder, auto-miner.

Reference mapping (src/custom_reth/mod.rs):
  * TxFilterConfig (mod.rs:220-250, configs/custom_node_config.toml):
    bridge contract address + bridgeAsset 4-byte selector, loaded from
    the `tx_filter_config` TOML table
  * the payload builder's bridge filter (mod.rs:499-547): txs to other
    addresses pass; txs to the bridge contract pass only if they are NOT
    bridgeAsset calls, except the FIRST bridgeAsset call per block
  * fee-ordered selection under a block gas cap (mod.rs:490-495,564-676)
  * execution + header assembly (mod.rs:687-788): per-tx EVM execution
    (sequencer/evm.py — the revm role) with Ethereum's Merkle-Patricia
    state root and rlp(index)-keyed transactions root (utils/mpt.py),
    receipts stored per tx

Blocks serve the same JSON shapes the workers/RPC consume (eth_* dicts).

A copy of eigen_zeth_tpu/sequencer/chain.py: host Python, no device
work; blocks, receipts and roots equal the JAX package's at equal
timestamps.
"""

from __future__ import annotations

import threading
import time
import tomllib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..ops import keccak
from ..utils import rlp
from . import evm as evm_m

BLOCK_GAS_LIMIT = 30_000_000


@dataclass
class TxFilterConfig:
    """Reference: custom_reth/mod.rs:220-250."""

    bridge_contract_address: str = ""
    bridge_asset_selector: str = ""

    @classmethod
    def from_conf_path(cls, path: str) -> "TxFilterConfig":
        with open(path, "rb") as f:
            conf = tomllib.load(f)
        t = conf.get("tx_filter_config", conf)
        return cls(
            bridge_contract_address=t.get("bridge_contract_address", ""),
            bridge_asset_selector=t.get("bridge_asset_selector", ""),
        )


def _tx_gas_price(tx: dict) -> int:
    v = tx.get("gasPrice", "0x0")
    return int(v, 16) if isinstance(v, str) else int(v)


def _tx_gas(tx: dict) -> int:
    v = tx.get("gas", "0x5208")
    return int(v, 16) if isinstance(v, str) else int(v)


class Mempool:
    """Fee-ordered pool (the best_transactions iterator analog; max_size
    plays the reth TxPoolArgs pending-pool-cap role)."""

    def __init__(self, max_size: int = 10_000):
        self._txs: List[dict] = []
        self._lock = threading.Lock()
        self.max_size = max_size

    def add(self, tx: dict) -> str:
        with self._lock:
            if len(self._txs) >= self.max_size:
                raise ValueError("txpool full")
            self._txs.append(dict(tx))
        return tx_hash(tx)

    def best_transactions(self) -> List[dict]:
        """Fee-ordered, but nonce-ascending per sender: each fee slot a
        sender wins is filled with that sender's LOWEST pending nonce, so
        a high-fee nonce-5 tx cannot jump its own nonce-4 (reth's
        best_transactions gives the same per-sender ordering guarantee,
        custom_reth/mod.rs:490-495)."""
        from ..utils import rlp as rlp_m

        with self._lock:
            txs = list(self._txs)
        fee_order = sorted(txs, key=_tx_gas_price, reverse=True)
        by_sender: Dict[str, List[dict]] = {}
        for t in sorted(txs, key=lambda t: rlp_m.tx_int(t.get("nonce"), 0)):
            by_sender.setdefault((t.get("from") or "").lower(), []).append(t)
        return [
            by_sender[(t.get("from") or "").lower()].pop(0) for t in fee_order
        ]

    def remove(self, txs: List[dict]) -> None:
        hashes = {tx_hash(t) for t in txs}
        with self._lock:
            self._txs = [t for t in self._txs if tx_hash(t) not in hashes]

    def __len__(self):
        with self._lock:
            return len(self._txs)


def tx_hash(tx: dict) -> str:
    """Canonical transaction hash.

    Signed txs hash their signed envelope — keccak(rlp(legacy tx with
    v,r,s)) or keccak(type || rlp(...)) for typed txs (decode_raw_tx
    stamps the latter as tx["hash"] = keccak of the raw wire bytes) —
    exactly what reth/any stock SDK computes.  Unsigned dev-tooling txs (no
    r/s) fall back to a deterministic non-canonical digest; such txs
    cannot exist on a real network."""
    if tx.get("hash"):
        return tx["hash"]
    if tx.get("r") and tx.get("s"):
        from ..utils import ethtx

        return "0x" + ethtx.tx_hash(tx, 0).hex()
    enc = rlp.encode(
        [
            str(tx.get("nonce", "0x0")).encode(),
            str(tx.get("from", "")).encode(),
            str(tx.get("to", "")).encode(),
            str(tx.get("value", "0x0")).encode(),
            str(tx.get("input", "0x")).encode(),
        ]
    )
    return "0x" + keccak.keccak256_host(enc).hex()


def make_bridge_filter(cfg: TxFilterConfig):
    """Per-block closure with the reference's first-bridge-asset-only
    semantics (custom_reth/mod.rs:499-547)."""
    state = {"seen": False}

    def allow(tx: dict) -> bool:
        to = tx.get("to")
        if to is None:
            return True  # creation txs always pass (mod.rs:512-515)
        if not cfg.bridge_contract_address or to.lower() != cfg.bridge_contract_address.lower():
            return True
        data = tx.get("input", "0x")
        selector = data[:10].lower() if data.startswith("0x") else "0x" + data[:8].lower()
        if selector != cfg.bridge_asset_selector.lower():
            return True
        if state["seen"]:
            return False
        state["seen"] = True
        return True

    return allow


class Ledger:
    """The execution layer: Ethereum account model + the EVM interpreter
    (sequencer/evm.py), with the REAL state commitment — a secure
    Merkle-Patricia trie over rlp([nonce, balance, storage_root,
    code_hash]) per account (the reference's expensive trie at
    custom_reth/mod.rs:714).  Supports value transfers, contract creation and
    message calls; dev-net accounts auto-fund on first touch."""

    # EIP-4788 beacon-roots system contract (pre-block call analog —
    # the reference applies pre_block_beacon_root_contract_call before
    # executing payload txs, custom_reth/mod.rs:554-580)
    BEACON_ROOTS_ADDRESS = "0x000f3df6d732807ef1319fb7b8bb8522d0beac02"
    HISTORY_BUFFER_LENGTH = 8191

    def __init__(self, chain_id: int = 12345, auto_fund: bool = True):
        from . import evm as evm_m

        self._evm_m = evm_m
        self.state = evm_m.WorldState(auto_fund=auto_fund)
        self.ctx = evm_m.BlockCtx(chain_id=chain_id)
        self.evm = evm_m.EVM(self.state, self.ctx)
        self.last_receipt: Optional[dict] = None

    def begin_block(
        self,
        number: int,
        timestamp: int,
        parent_beacon_root: bytes = b"\x00" * 32,
        excess_blob_gas: int = 0,
        block_hash_fn=None,
    ) -> None:
        self.ctx.number = number
        self.ctx.timestamp = timestamp
        # EIP-4844: this block's blob base fee from its excess blob gas
        self.ctx.blob_basefee = evm_m.blob_base_fee(excess_blob_gas)
        # BLOCKHASH: canonical last-256 lookup into the sealed chain
        self.ctx.block_hash_fn = block_hash_fn
        # EIP-4788 ring buffer: slot ts%N <- ts, slot ts%N + N <- root.
        # On this L2 the "beacon root" is the parent L2 block hash (no CL);
        # the write is real state, visible to contracts and the state root.
        acct = self.state.touch(self.BEACON_ROOTS_ADDRESS)
        slot = timestamp % self.HISTORY_BUFFER_LENGTH
        acct.storage[slot] = timestamp
        acct.storage[slot + self.HISTORY_BUFFER_LENGTH] = int.from_bytes(
            parent_beacon_root, "big"
        )

    def execute(self, tx: dict) -> bool:
        sender = (tx.get("from") or "0x" + "00" * 20).lower()
        receipt = self.evm.execute_tx(tx, sender)
        self.last_receipt = receipt
        return receipt["status"] == 1

    # legacy views used by tests/rpc
    @property
    def balances(self) -> Dict[str, int]:
        return {a: acc.balance for a, acc in self.state.accounts.items()}

    @property
    def nonces(self) -> Dict[str, int]:
        return {a: acc.nonce for a, acc in self.state.accounts.items()}

    def state_root(self) -> bytes:
        return self.state.state_root()


class Sequencer:
    """Block producer + chain store; serves the chain-client interface the
    workers/RPC consume (block_number / get_block_by_number / add tx)."""

    def __init__(
        self,
        tx_filter: Optional[TxFilterConfig] = None,
        chain_id: int = 12345,
        verify_signatures: bool = False,
        block_gas_limit: int = BLOCK_GAS_LIMIT,
        coinbase: Optional[str] = None,
        txpool_max_size: int = 10_000,
        auto_fund: bool = True,
    ):
        self.pool = Mempool(max_size=txpool_max_size)
        self.ledger = Ledger(chain_id=chain_id, auto_fund=auto_fund)
        self.block_gas_limit = block_gas_limit
        if coinbase:
            self.ledger.ctx.coinbase = coinbase.lower()
        self.ledger.ctx.gas_limit = block_gas_limit
        self.filter_cfg = tx_filter or TxFilterConfig()
        self.chain_id = chain_id
        self._receipts: Dict[str, dict] = {}
        # block-number -> receipts, in tx order: eth_getLogs walks only
        # the requested range instead of every receipt ever stored
        self._receipts_by_block: Dict[int, List[dict]] = {}
        self._traces: Dict[str, Optional[dict]] = {}
        # revm-style sender recovery (custom_reth/mod.rs:604-640 executes
        # recovered txs); opt-in because dev tooling submits unsigned txs
        self.verify_signatures = verify_signatures
        self._lock = threading.Lock()
        genesis_root = self.ledger.state_root()
        from ..utils import header as header_m
        from ..utils import mpt

        genesis = {
            "number": "0x0",
            "parentHash": "0x" + "00" * 32,
            "sha3Uncles": "0x" + header_m.EMPTY_OMMERS_HASH.hex(),
            "stateRoot": "0x" + genesis_root.hex(),
            "transactionsRoot": "0x" + mpt.EMPTY_ROOT.hex(),
            "receiptsRoot": "0x" + mpt.EMPTY_ROOT.hex(),
            "logsBloom": "0x" + "00" * 256,
            "miner": self.ledger.ctx.coinbase,
            "difficulty": "0x0",
            "extraData": "0x",
            "mixHash": "0x" + "00" * 32,
            "nonce": "0x0000000000000000",
            "gasLimit": hex(block_gas_limit),
            "baseFeePerGas": hex(self.ledger.ctx.basefee),
            "timestamp": "0x0",
            "gasUsed": "0x0",
            "withdrawalsRoot": "0x" + mpt.EMPTY_ROOT.hex(),
            "withdrawals": [],
            "blobGasUsed": "0x0",
            "excessBlobGas": "0x0",
            "parentBeaconBlockRoot": "0x" + "00" * 32,
            "transactions": [],
        }
        # canonical seal: keccak(rlp(header)) — utils/header.py
        genesis["hash"] = header_m.block_hash(genesis)
        self._blocks: List[dict] = [genesis]
        # PoS forkchoice markers (engine_forkchoiceUpdatedV3 state): the
        # reference's CL (lighthouse bn/vc over a 64-validator genesis,
        # scripts/launch-pos-eigen-zeth-node.sh:54-61) distinguishes
        # head/safe/finalized; a reorg can move the head to any canonical
        # ancestor ABOVE the finalized block, never below it.
        self.safe_hash: str = genesis["hash"]
        self.finalized_hash: str = genesis["hash"]
        # per-block post-state snapshots back the reorg path; finalized
        # blocks can never reorg, so only a bounded trailing window of
        # snapshots is retained (2 epochs of 32 slots in mainnet terms)
        self.SNAPSHOT_WINDOW = 64
        self._state_snaps: Dict[int, dict] = {0: self.ledger.state.snapshot()}
        self._basefee_snaps: Dict[int, int] = {0: self.ledger.ctx.basefee}

    # -- chain-client surface -------------------------------------------------

    def block_number(self) -> int:
        with self._lock:
            return len(self._blocks) - 1

    def get_block_by_number(self, number, full_txs: bool = False):
        if isinstance(number, str) and not number.startswith("0x"):
            # block tags: safe/finalized resolve through the forkchoice
            # markers the CL set (engine API), not simply to the head
            if number in ("latest", "pending"):
                number = self.block_number()
            elif number == "earliest":
                number = 0
            elif number == "safe":
                return self.get_block_by_hash(self.safe_hash)
            elif number == "finalized":
                return self.get_block_by_hash(self.finalized_hash)
        n = int(number, 16) if isinstance(number, str) else int(number)
        with self._lock:
            if 0 <= n < len(self._blocks):
                return dict(self._blocks[n])
        return None

    def get_block_by_hash(self, block_hash: str):
        h = block_hash.lower()
        with self._lock:
            for b in reversed(self._blocks):
                if b["hash"].lower() == h:
                    return dict(b)
        return None

    # -- PoS forkchoice (engine_forkchoiceUpdatedV3 state) -------------------

    def _canon_number(self, block_hash: Optional[str]) -> Optional[int]:
        """Canonical height of a block hash, or None.  Caller holds _lock."""
        h = (block_hash or "").lower()
        if not h or set(h[2:]) <= {"0"}:
            return None
        for i in range(len(self._blocks) - 1, -1, -1):
            if self._blocks[i]["hash"].lower() == h:
                return i
        return None

    def set_forkchoice(
        self,
        head_hash: Optional[str] = None,
        safe_hash: Optional[str] = None,
        finalized_hash: Optional[str] = None,
    ) -> str:
        """Apply a CL forkchoice update: optionally REORG the head to a
        canonical ancestor (state rolls back to that block's post-state
        snapshot; orphaned txs re-enter the mempool, as reth's reorg
        handling re-injects them), then advance the safe/finalized
        markers.  Rules enforced: safe and finalized must be canonical;
        finalized is monotonic; nothing at or below the finalized height
        ever reorgs.  Returns "VALID", or "SYNCING" for an unknown head
        (the engine-API status for a head this EL has not seen).
        Reference analog: the embedded reth's forkchoice handling under
        lighthouse (launch-pos-eigen-zeth-node.sh:54-61)."""
        with self._lock:
            if head_hash:
                n = self._canon_number(head_hash)
                if n is None:
                    return "SYNCING"
                head = len(self._blocks) - 1
                if n < head:
                    fin = self._canon_number(self.finalized_hash) or 0
                    if n < fin:
                        raise ValueError(
                            f"reorg target #{n} is below finalized #{fin}")
                    snap = self._state_snaps.get(n)
                    if snap is None:
                        raise ValueError(
                            f"reorg target #{n} outside the snapshot window")
                    orphaned = self._blocks[n + 1:]
                    del self._blocks[n + 1:]
                    for b in orphaned:
                        bn = int(b["number"], 16)
                        for r in self._receipts_by_block.pop(bn, []):
                            self._receipts.pop(r["transactionHash"], None)
                            self._traces.pop(r["transactionHash"], None)
                        for t in b["transactions"]:
                            try:
                                self.pool.add(t)
                            except ValueError:
                                pass  # pool full: tx is simply dropped
                        self._state_snaps.pop(bn, None)
                        self._basefee_snaps.pop(bn, None)
                    # restore a COPY: later execution must not mutate the
                    # retained snapshot (a second reorg to the same block
                    # must see the original state)
                    self.ledger.state.restore(
                        {a: evm_m.Account(acc.nonce, acc.balance, acc.code,
                                          dict(acc.storage))
                         for a, acc in snap.items()})
                    self.ledger.ctx.basefee = self._basefee_snaps.get(
                        n, self.ledger.ctx.basefee)
                    from ..utils.profiling import METRICS

                    METRICS.inc("reorgs")
            if finalized_hash:
                fn = self._canon_number(finalized_hash)
                if fn is not None:
                    cur = self._canon_number(self.finalized_hash) or 0
                    if fn < cur:
                        raise ValueError(
                            f"finalized must be monotonic ({fn} < {cur})")
                    self.finalized_hash = self._blocks[fn]["hash"]
                elif set(finalized_hash.lower()[2:]) - {"0"}:
                    return "SYNCING"
            if safe_hash:
                sn = self._canon_number(safe_hash)
                if sn is not None:
                    fn = self._canon_number(self.finalized_hash) or 0
                    if sn < fn:
                        raise ValueError(
                            f"safe #{sn} below finalized #{fn}")
                    self.safe_hash = self._blocks[sn]["hash"]
                elif set(safe_hash.lower()[2:]) - {"0"}:
                    return "SYNCING"
            return "VALID"

    def get_transaction_by_hash(self, txh: str) -> Optional[dict]:
        """The mined tx joined with its location (eth_getTransactionByHash)."""
        with self._lock:
            r = self._receipts.get(txh)
        if r is None:
            return None
        block = self.get_block_by_number(r["blockNumber"])
        idx = int(r["transactionIndex"], 16)
        tx = dict(block["transactions"][idx])
        tx.update(
            hash=txh, blockHash=r["blockHash"],
            blockNumber=r["blockNumber"], transactionIndex=r["transactionIndex"],
        )
        return tx

    def send_raw_transaction(self, tx: dict) -> str:
        return self.pool.add(tx)

    # -- block building (the custom_payload_builder analog) ------------------

    def build_block(
        self,
        timestamp: Optional[int] = None,
        parent_beacon_block_root: Optional[str] = None,
        fee_recipient: Optional[str] = None,
        withdrawals: Optional[List[dict]] = None,
    ) -> dict:
        """parent_beacon_block_root / fee_recipient / withdrawals mirror
        the engine API's PayloadAttributes (the reference wraps Eth
        payload attributes at custom_reth/mod.rs:84-182 and commits
        withdrawals after the tx loop, mod.rs:687-699); absent, the
        parent L2 block hash / configured coinbase / no withdrawals are
        used."""
        allow = make_bridge_filter(self.filter_cfg)
        included: List[dict] = []
        receipts: List[dict] = []
        rejected: List[dict] = []  # permanently invalid: evict (mark_invalid analog)
        gas_used = 0
        ts = timestamp if timestamp is not None else int(time.time())
        with self._lock:
            parent_hash_hex = self._blocks[-1]["hash"]
        beacon_root_hex = parent_beacon_block_root or parent_hash_hex
        if fee_recipient:
            self.ledger.ctx.coinbase = fee_recipient.lower()
        with self._lock:
            parent_hdr = self._blocks[-1]
        # EIP-4844 excess-blob-gas update rule for THIS block
        p_excess = int(parent_hdr.get("excessBlobGas", "0x0"), 16)
        p_used = int(parent_hdr.get("blobGasUsed", "0x0"), 16)
        excess_blob_gas = max(
            0, p_excess + p_used - evm_m.TARGET_BLOB_GAS_PER_BLOCK
        )

        def _bh_lookup(bn: int) -> int:
            with self._lock:
                if 0 <= bn < len(self._blocks):
                    return int(self._blocks[bn]["hash"], 16)
            return 0

        self.ledger.begin_block(
            self.block_number() + 1, ts,
            parent_beacon_root=bytes.fromhex(beacon_root_hex[2:]),
            excess_blob_gas=excess_blob_gas,
            block_hash_fn=_bh_lookup,
        )
        blob_gas_used = 0
        for tx in self.pool.best_transactions():
            if _tx_gas(tx) > self.block_gas_limit:
                rejected.append(tx)  # can never fit any block
                continue
            if gas_used + _tx_gas(tx) > self.block_gas_limit:
                continue  # skip over-budget tx, keep scanning (mod.rs:575-592)
            tx_blob_gas = len(tx.get("blobVersionedHashes") or []) * evm_m.GAS_PER_BLOB
            if blob_gas_used + tx_blob_gas > evm_m.MAX_BLOB_GAS_PER_BLOCK:
                continue  # blob budget full: defer to a later block
            if not allow(tx):
                # bridge-filtered: deferred, not evicted — the per-block
                # first-bridge-asset window reopens next block
                continue
            exec_tx = tx
            if self.verify_signatures:
                from ..utils import ethtx

                sender = ethtx.recover_sender(tx, self.chain_id)
                if sender is None or (
                    tx.get("from") and tx["from"].lower() != sender
                ):
                    rejected.append(tx)  # bad/forged signature: evict
                    continue
                exec_tx = dict(tx, **{"from": sender})
            if not self.ledger.execute(exec_tx):
                err = (self.ledger.last_receipt or {}).get("error")
                if err == "nonce-future":
                    # not yet valid: defer (stays pooled for a later
                    # block once the nonce gap fills)
                    continue
                # execution failure / stale nonce (replay): drop from the
                # pool like reth's best_txs.mark_invalid (mod.rs:604-640
                # error path) — otherwise it is re-scanned every block
                rejected.append(tx)
                continue
            included.append(tx)
            rcpt = dict(self.ledger.last_receipt or {})
            rcpt["transactionHash"] = tx_hash(tx)
            self._traces[rcpt["transactionHash"]] = rcpt.pop("trace", None)
            rcpt["logs"] = [
                {
                    "address": l.address,
                    "topics": ["0x%064x" % t for t in l.topics],
                    "data": "0x" + l.data.hex(),
                }
                for l in rcpt.get("logs", [])
            ]
            receipts.append(rcpt)
            gas_used += rcpt.get("gasUsed", 0) or _tx_gas(tx)
            blob_gas_used += rcpt.get("blobGasUsed", 0)
        self.pool.remove(included + rejected)

        # EIP-4895: credit withdrawal amounts (Gwei) AFTER the tx loop —
        # balance changes land in this block's post-state, and the header
        # commits to the withdrawal list via an rlp(index)-keyed trie
        # (the reference's commit_withdrawals, custom_reth/mod.rs:687-699)
        from ..utils import mpt, rlp as rlp_m

        wds = withdrawals or []
        wd_encoded: List[bytes] = []
        for w in wds:
            amount_gwei = rlp_m.tx_int(w.get("amount", 0))
            addr = (w.get("address") or "0x" + "00" * 20).lower()
            self.ledger.state.touch(addr).balance += amount_gwei * 10**9
            wd_encoded.append(
                rlp_m.encode([
                    rlp_m.tx_int(w.get("index", 0)),
                    rlp_m.tx_int(w.get("validatorIndex", 0)),
                    bytes.fromhex(addr[2:]),
                    amount_gwei,
                ])
            )
        wd_root = mpt.index_root(wd_encoded) if wd_encoded else mpt.EMPTY_ROOT

        with self._lock:
            from ..utils import receipts as rc

            parent = self._blocks[-1]
            n = len(self._blocks)
            # Ethereum's transactions root: trie keyed by rlp(index) over
            # the worker's exact RLP packing (shared with the prover)
            tx_root = mpt.index_root(
                [rlp_m.encode_legacy_tx(t, self.chain_id) for t in included]
            )
            state_root = self.ledger.state_root()
            # canonical receipts root + logs bloom (mod.rs:687-788: reth's
            # calculate_receipt_root / Bloom aggregation roles)
            rcpt_root = rc.receipts_root(receipts)
            bloom = rc.block_bloom(receipts)
            from ..utils import header as header_m

            block = {
                "number": hex(n),
                "parentHash": parent["hash"],
                "sha3Uncles": "0x" + header_m.EMPTY_OMMERS_HASH.hex(),
                "stateRoot": "0x" + state_root.hex(),
                "transactionsRoot": "0x" + tx_root.hex(),
                "receiptsRoot": "0x" + rcpt_root.hex(),
                "logsBloom": "0x" + bloom.hex(),
                "miner": self.ledger.ctx.coinbase,
                # post-merge constants (difficulty 0, zero PoW nonce);
                # mixHash carries prevRandao — this L2 has no randao, 0
                "difficulty": "0x0",
                "extraData": "0x",
                "mixHash": "0x" + "00" * 32,
                "nonce": "0x0000000000000000",
                "gasLimit": hex(self.block_gas_limit),
                "baseFeePerGas": hex(self.ledger.ctx.basefee),
                "timestamp": hex(ts),
                "gasUsed": hex(gas_used),
                # Shanghai/Cancun fields the reference's builder seals
                # (withdrawals + EIP-4844 blob gas + EIP-4788 beacon root,
                # mod.rs:687-788); no blob txs on this L2
                "withdrawalsRoot": "0x" + wd_root.hex(),
                "withdrawals": wds,
                "blobGasUsed": hex(blob_gas_used),
                "excessBlobGas": hex(excess_blob_gas),
                "parentBeaconBlockRoot": beacon_root_hex,
                "transactions": included,
            }
            # canonical seal: keccak(rlp(header)), reproducing reth's
            # header.seal_slow() (custom_reth/mod.rs:751-788)
            block["hash"] = header_m.block_hash(block)
            self._blocks.append(block)
            # EIP-1559 base-fee update for the NEXT block: +-1/8 toward
            # the half-gas-limit target (a zero genesis base fee stays
            # zero — the dev chain's default; a funded fee market starts
            # from a nonzero genesis baseFeePerGas)
            base = self.ledger.ctx.basefee
            if base:
                target = self.block_gas_limit // 2
                if gas_used > target:
                    base += max(1, base * (gas_used - target) // target // 8)
                elif gas_used < target:
                    base -= base * (target - gas_used) // target // 8
                self.ledger.ctx.basefee = max(base, 0)
            from ..utils.profiling import METRICS

            METRICS.inc("blocks_built")
            METRICS.inc("txs_executed", len(included))
            cum = 0
            for i, (t, r) in enumerate(zip(included, receipts)):
                cum += int(r.get("gasUsed", 0) or 0)
                r.update(
                    blockNumber=hex(n), blockHash=block["hash"],
                    transactionIndex=hex(i),
                    cumulativeGasUsed=hex(cum),
                    logsBloom="0x" + rc.logs_bloom(r.get("logs", [])).hex(),
                )
                self._receipts[r["transactionHash"]] = r
            self._receipts_by_block[n] = receipts
            # post-state snapshot backs a future reorg to this block;
            # drop snapshots past the finality window
            self._state_snaps[n] = self.ledger.state.snapshot()
            self._basefee_snaps[n] = self.ledger.ctx.basefee
            for k in [k for k in self._state_snaps
                      if k < n - self.SNAPSHOT_WINDOW]:
                self._state_snaps.pop(k, None)
                self._basefee_snaps.pop(k, None)
            return block

    def call_view(self, tx: dict) -> str:
        """eth_call against the current state (no state change)."""
        return "0x" + self.ledger.evm.call_view(tx).hex()

    def estimate_gas(self, tx: dict) -> int:
        """eth_estimateGas: dry-run against a state snapshot."""
        return self.ledger.evm.estimate_gas(tx)

    def fee_history(self, block_count: int, newest, percentiles=None) -> dict:
        """eth_feeHistory over the sealed headers (baseFeePerGas +
        gasUsedRatio per block; this L2 has no priority-fee market, so
        requested reward percentiles are all zero)."""
        head = self.block_number()
        newest_n = head if newest in (None, "latest", "pending", "safe",
                                      "finalized") else (
            int(newest, 16) if isinstance(newest, str) else int(newest))
        newest_n = min(newest_n, head)
        oldest = max(0, newest_n - block_count + 1)
        base, ratio = [], []
        for n in range(oldest, newest_n + 1):
            b = self.get_block_by_number(n)
            base.append(b["baseFeePerGas"])
            ratio.append(int(b["gasUsed"], 16) / max(int(b["gasLimit"], 16), 1))
        # one extra entry: next block's base fee (flat on this L2)
        base.append(base[-1] if base else "0x0")
        out = {"oldestBlock": hex(oldest), "baseFeePerGas": base,
               "gasUsedRatio": ratio}
        if percentiles:
            out["reward"] = [["0x0"] * len(percentiles) for _ in ratio]
        return out

    def get_transaction_trace(self, txh: str) -> Optional[dict]:
        """geth-callTracer-shaped call tree for a mined transaction."""
        with self._lock:
            return self._traces.get(txh)

    def get_logs(
        self,
        from_block: int = 0,
        to_block: Optional[int] = None,
        address: Optional[str] = None,
        topics: Optional[list] = None,
    ) -> List[dict]:
        """eth_getLogs: block-range index walk (only blocks in
        [from_block, to_block] are touched), per-receipt bloom prefilter
        (never a false negative), then exact address/positional-topic
        matching; logIndex is block-wide, in tx order."""
        from ..utils import receipts as rc

        with self._lock:
            head = len(self._blocks) - 1
            hi = head if to_block is None else min(to_block, head)
            receipts = [
                r
                for bn in range(max(from_block, 0), hi + 1)
                for r in self._receipts_by_block.get(bn, ())
            ]
        addr = address.lower() if address else None
        want = topics or []

        def topic_match(log_topics: List[str]) -> bool:
            for i, w in enumerate(want):
                if w is None:
                    continue
                if i >= len(log_topics):
                    return False
                opts = [w] if isinstance(w, str) else list(w)
                if log_topics[i].lower() not in (o.lower() for o in opts):
                    return False
            return True

        out: List[dict] = []
        log_index: Dict[int, int] = {}  # block -> running block-wide index
        for r in receipts:
            bn = int(r["blockNumber"], 16)
            base = log_index.setdefault(bn, 0)
            n_logs = len(r.get("logs", []))
            log_index[bn] = base + n_logs
            if not (from_block <= bn <= hi) or not n_logs:
                continue
            bloom = int(r.get("logsBloom", "0x0"), 16)
            if addr and not rc.bloom_contains(bloom, bytes.fromhex(addr[2:])):
                continue
            for j, log in enumerate(r["logs"]):
                if addr and log["address"].lower() != addr:
                    continue
                if not topic_match(log["topics"]):
                    continue
                out.append({
                    **log,
                    "blockNumber": r["blockNumber"],
                    "blockHash": r["blockHash"],
                    "transactionHash": r["transactionHash"],
                    "transactionIndex": r["transactionIndex"],
                    "logIndex": hex(base + j),
                    "removed": False,
                })
        return out

    def get_transaction_receipt(self, txh: str) -> Optional[dict]:
        with self._lock:
            r = self._receipts.get(txh)
        if r is None:
            return None
        out = dict(r)
        out["status"] = hex(out.get("status", 0))
        out["gasUsed"] = hex(out.get("gasUsed", 0))
        return out

    # -- auto-mine loop (the reference PoC's --auto-mine, README.md:13-18) ---

    def start_auto_mine(self, stop: threading.Event, interval: float = 2.0) -> threading.Thread:
        def loop():
            while not stop.is_set():
                if len(self.pool):
                    self.build_block()
                stop.wait(interval)

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        return t
