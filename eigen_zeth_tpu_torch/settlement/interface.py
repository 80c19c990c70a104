"""Settlement trait + registry — mirror of src/settlement/mod.rs:16-127.

Three implementations: Ethereum (contract calldata over JSON-RPC,
settlement/ethereum.py), Custom (bridge-service REST,
settlement/custom.py), and Mock (in-memory, the test/devnet stand-in the
reference lacks — its tests hit live services instead).

A copy of eigen_zeth_tpu/settlement/interface.py."""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import List


@dataclass
class BatchData:
    """Reference: src/settlement/mod.rs:16-21."""

    transactions: bytes
    global_exit_root: bytes  # 32 bytes
    timestamp: int


class Settlement(ABC):
    """The 10-method surface (reference: src/settlement/mod.rs:26-111)."""

    # -- bridge --------------------------------------------------------------

    @abstractmethod
    def bridge_asset(
        self,
        destination_network: int,
        destination_address: str,
        amount: int,
        token: str,
        force_update_global_exit_root: bool,
        calldata: bytes,
    ) -> None: ...

    @abstractmethod
    def bridge_message(
        self,
        destination_network: int,
        destination_address: str,
        force_update_global_exit_root: bool,
        calldata: bytes,
    ) -> None: ...

    @abstractmethod
    def claim_asset(
        self,
        smt_proof: List[bytes],
        index: int,
        mainnet_exit_root: bytes,
        rollup_exit_root: bytes,
        origin_network: int,
        origin_token_address: str,
        destination_network: int,
        destination_address: str,
        amount: int,
        metadata: bytes,
    ) -> None: ...

    @abstractmethod
    def claim_message(
        self,
        smt_proof: List[bytes],
        index: int,
        mainnet_exit_root: bytes,
        rollup_exit_root: bytes,
        origin_network: int,
        origin_address: str,
        destination_network: int,
        destination_address: str,
        amount: int,
        metadata: bytes,
    ) -> None: ...

    # -- global exit root ----------------------------------------------------

    @abstractmethod
    def update_exit_root(self, network: int, new_root: bytes) -> None: ...

    @abstractmethod
    def get_global_exit_root(self) -> bytes: ...

    @abstractmethod
    def get_last_rollup_exit_root(self) -> bytes: ...

    # -- zkvm ----------------------------------------------------------------

    @abstractmethod
    def sequence_batches(self, batches: List[BatchData]) -> None: ...

    @abstractmethod
    def verify_batches(
        self,
        pending_state_num: int,
        init_num_batch: int,
        final_new_batch: int,
        new_local_exit_root: bytes,
        new_state_root: bytes,
        proof: str,
        input: str,
    ) -> None: ...

    @abstractmethod
    def verify_batches_trusted_aggregator(
        self,
        pending_state_num: int,
        init_num_batch: int,
        final_new_batch: int,
        new_local_exit_root: bytes,
        new_state_root: bytes,
        proof: str,
        input: str,
    ) -> None: ...


def init_settlement_provider(spec: str, **kwargs) -> Settlement:
    """NetworkSpec factory (reference: src/settlement/mod.rs:113-127;
    'Optimism' is an unimplemented todo there as well)."""
    if spec == "ethereum":
        from .ethereum import EthereumSettlement, EthereumSettlementConfig

        cfg = kwargs.get("config")
        if isinstance(cfg, str):
            cfg = EthereumSettlementConfig.from_conf_path(cfg)
        return EthereumSettlement(cfg)
    if spec == "custom":
        from .custom import CustomSettlement

        return CustomSettlement(kwargs.get("bridge_service_addr"))
    if spec == "mock":
        from .mock import MockSettlement

        return MockSettlement()
    raise ValueError(f"unknown network spec {spec!r}")
