"""CLI — `python -m eigen_zeth_tpu_torch <subcommand>`, the port of the JAX
package's command surface (eigen_zeth_tpu/cli.py): Run | Prover | Init |
ChainInfo | Config.

`run` wires the whole node as the JAX command does: rollup DB, sequencer,
operator workers, eigenrpc server, signal handling (the reference's
src/commands/run.rs:156-300).  It takes the JAX command's arguments and one
more, `--device`: without `--prover-addr` and `--no-prover` the node proves
in process on that device, the card unless `--device cpu` is given, and a
missing CUDA device stops the command.  With `--prover-addr` (the
reference's PROVER_ADDR topology) or `--no-prover` the node does no device
work.  `--database native` opens the C++ zethdb engine (built with g++ at
first use; a failed build stops the command, with no fallback to FileDb), and
`--settlement custom` settles through the bridge service at
BRIDGE_SERVICE_ADDR (`settlement/bridge_mock.py` serves one).

`prover` runs the prover-network side of a deployment: it serves
ProverService over gRPC and proves on the card the blocks of the L2 it is
pointed at, so a node (`run --prover-addr`) reaches the port.  It takes the
JAX command's arguments, and two more: `--device` (as for `run`) and
`--crs-dir` (as `run --crs-dir`).

`init` writes the genesis record into a fresh rollup KV; `chain-info` and
`config` are unimplemented stubs, as in the reference.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import threading

import torch

from .models import stark
from .operator import Operator
from .protocol import kv, rpc
from .protocol.prover_service import BatchProver, ChainExecutor
from .sequencer.chain import BLOCK_GAS_LIMIT, Sequencer, TxFilterConfig
from .settlement.ethereum import JsonRpcClient
from .settlement.interface import init_settlement_provider
from .settlement.worker import WorkerConfig
from .utils.config import global_env

log = logging.getLogger("ezt.cli")

GENESIS_KEY = b"GENESIS"

DEVICE_HELP = "torch device to prove on; the CPU only when asked for with --device cpu"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="eigen-zeth-tpu-torch")
    sub = p.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="launch the node (operator + sequencer + rpc)")
    run.add_argument("--database", choices=["memory", "file", "native"], default="memory")
    run.add_argument("--db-path", default="tmp/zeth.db")
    run.add_argument("--settlement", choices=["mock", "custom", "ethereum"], default="mock")
    run.add_argument("--settlement-conf", default=None,
                     help="TOML path for the ethereum settlement config")
    run.add_argument("--tx-filter-conf", default=None,
                     help="TOML path for the tx filter (custom_node_config.toml)")
    run.add_argument("--worker-conf", default=None,
                     help="TOML path for worker intervals (settlement.toml)")
    run.add_argument("--rpc-host", default="127.0.0.1")
    run.add_argument("--rpc-port", type=int, default=8546)
    run.add_argument("--auto-mine-interval", type=float, default=2.0,
                     help="dev auto-mine cadence (reth --dev.block-time)")
    run.add_argument("--aggregator-addr", default="0x" + "00" * 20)
    # --- reth arg-surface analogs (src/commands/reth.rs) -----------------
    run.add_argument("--datadir", default=None,
                     help="alias of --db-path (reth --datadir)")
    run.add_argument("--chain-id", type=int, default=None,
                     help="L2 chain id (reth --chain)")
    run.add_argument("--instance", type=int, default=1,
                     help="node instance number; offsets the RPC port by "
                          "instance-1 (reth --instance port arithmetic)")
    run.add_argument("--metrics", default=None, metavar="HOST:PORT",
                     help="serve prometheus metrics on a separate socket "
                          "(reth --metrics); /metrics is always on the "
                          "RPC port too")
    run.add_argument("--coinbase", default=None,
                     help="block fee recipient (reth --builder suggested "
                          "fee recipient)")
    run.add_argument("--block-gas-limit", type=int, default=None,
                     help="block gas cap (reth --builder.gaslimit)")
    run.add_argument("--txpool-max-size", type=int, default=10_000,
                     help="pending-pool cap (reth --txpool.* args)")
    run.add_argument("--verify-signatures", action="store_true",
                     help="require valid secp256k1 signatures (revm "
                          "sender recovery; off for dev tooling)")
    run.add_argument("--dev-fund", action="store_true",
                     help="auto-fund accounts on first touch (reth --dev "
                          "prefunded-accounts analog); the node path "
                          "defaults to real balance enforcement")
    run.add_argument("--no-prover", action="store_true",
                     help="start without proving workers (sequencer+rpc only)")
    run.add_argument("--prover-addr", default=None,
                     help="gRPC address of an external prover process "
                          "(the reference's PROVER_ADDR topology); "
                          "default: the in-process prover on --device")
    run.add_argument("--final-wrap", choices=["stark", "mimc", "linear"],
                     default="stark",
                     help="final Groth16 circuit: 'stark' verifies the "
                          "wrap-profile attestation STARKs IN-CIRCUIT "
                          "(sound; FinalProof alone implies batch "
                          "validity); 'mimc'/'linear' wrap only the "
                          "aggregated digest (fast dev profiles)")
    run.add_argument("--crs-dir", default=None,
                     help="Groth16 CRS artifact directory (persisted "
                          "pk.npz + pinned vk.json per circuit shape; "
                          "default artifacts/crs — models/crs.py)")
    run.add_argument("--device", default="cuda", help=DEVICE_HELP)

    prover = sub.add_parser(
        "prover", help="standalone gRPC prover server (the prover-network side)"
    )
    prover.add_argument("--host", default="127.0.0.1")
    prover.add_argument("--port", type=int, default=50061)
    prover.add_argument("--l2-addr", default=None,
                        help="L2 JSON-RPC url for the chain executor "
                             "(default: ZETH_L2_ADDR)")
    prover.add_argument("--stark-profile", choices=["production", "test"],
                        default="production",
                        help="test = tiny STARK params for CI/CPU")
    prover.add_argument("--no-jit", action="store_true",
                        help="accepted for the JAX command's scripts; no effect here")
    prover.add_argument("--final-wrap", choices=["stark", "mimc", "linear"],
                        default="stark",
                        help="final Groth16 circuit: 'stark' verifies the "
                             "wrap-profile attestation STARKs in-circuit (sound); "
                             "'mimc'/'linear' wrap only the aggregated digest")
    prover.add_argument("--crs-dir", default=None,
                        help="Groth16 CRS artifact directory (persisted pk.npz + "
                             "pinned vk.json per circuit shape; default artifacts/crs)")
    prover.add_argument("--device", default="cuda", help=DEVICE_HELP)

    init = sub.add_parser("init", help="initialize the L2 genesis / rollup DB")
    init.add_argument("--database", choices=["memory", "file", "native"], default="file")
    init.add_argument("--db-path", default="tmp/zeth.db")
    init.add_argument("--chain-id", type=int, default=None)

    sub.add_parser("chain-info", help="unimplemented (parity with the reference stub)")
    sub.add_parser("config", help="unimplemented (parity with the reference stub)")
    return p


def prover_device(name: str, command: str = "prover") -> torch.device:
    """The device the prover was asked for; a CUDA device that this process
    cannot reach stops the command rather than proving anywhere else."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{command}: device {name!r} asked for, but torch.cuda.is_available() "
                         "is False (pass --device cpu to prove on the CPU)")
    return device


def cmd_init(args) -> int:
    env = global_env()
    db = kv.open_db(args.database, args.db_path)
    chain_id = args.chain_id if args.chain_id is not None else env.chain_id
    genesis = {
        "chain_id": chain_id,
        "program_name": env.program_name,
        "curve_type": env.curve_type,
    }
    db.put(GENESIS_KEY, json.dumps(genesis).encode())
    db.put_u64(kv.KEY_LAST_SEQUENCE_FINALITY_BLOCK_NUMBER, 0)
    print(f"initialized genesis for chain {chain_id} in {args.database} db")
    return 0


def cmd_run(args, wait: bool = True):
    """Run the node: sequencer, eigenrpc, and the operator's workers over the
    in-process prover on --device (or a remote one at --prover-addr).  With
    wait=False the started handles are returned and the caller shuts them
    down (`shutdown()`)."""
    in_process = not args.no_prover and not args.prover_addr
    # before anything starts: a card that is not there stops the command
    device = prover_device(args.device, "run") if in_process else None
    env = global_env()
    if args.datadir:
        args.db_path = args.datadir
    if args.instance > 1:
        args.rpc_port += args.instance - 1
    db = kv.open_db(args.database, args.db_path)
    tx_filter = (
        TxFilterConfig.from_conf_path(args.tx_filter_conf)
        if args.tx_filter_conf
        else TxFilterConfig()
    )
    worker_config = (
        WorkerConfig.from_conf_path(args.worker_conf)
        if args.worker_conf
        else WorkerConfig()
    )
    sequencer = Sequencer(
        tx_filter=tx_filter,
        chain_id=args.chain_id or env.chain_id,
        verify_signatures=args.verify_signatures,
        block_gas_limit=args.block_gas_limit or BLOCK_GAS_LIMIT,
        coinbase=args.coinbase,
        txpool_max_size=args.txpool_max_size or 10_000,
        auto_fund=args.dev_fund,
    )

    settlement_kwargs = {}
    if args.settlement == "custom":
        settlement_kwargs["bridge_service_addr"] = env.bridge_service_addr
    if args.settlement == "ethereum":
        settlement_kwargs["config"] = args.settlement_conf
    settlement = init_settlement_provider(args.settlement, **settlement_kwargs)

    stop = threading.Event()
    server = rpc.EigenRpcServer(db, sequencer, host=args.rpc_host, port=args.rpc_port)
    server.start()
    log.info("eigenrpc listening on %s:%d", args.rpc_host, server.port)

    metrics_server = None
    if args.metrics:
        mhost, _, mport = args.metrics.rpartition(":")
        metrics_server = rpc.MetricsServer(mhost or "127.0.0.1", int(mport)).start()
        log.info("metrics listening on %s:%d", mhost or "127.0.0.1", metrics_server.port)

    # auto-mine is the PoC dev mode (reference README.md:13-18); interval
    # <= 0 disables it so blocks come through the engine API or the caller
    if args.auto_mine_interval > 0:
        sequencer.start_auto_mine(stop, args.auto_mine_interval)

    operator = None
    if not args.no_prover:
        if args.prover_addr:
            # two-process topology: proving happens in an external prover
            # process at PROVER_ADDR (the reference's deployment shape)
            from .protocol.grpc_shim import RemoteBatchProver

            prover = RemoteBatchProver(args.prover_addr)
        else:
            prover = BatchProver(
                executor=ChainExecutor(sequencer),
                wrap=args.final_wrap,
                crs_dir=args.crs_dir,
                device=device,
            )
            # pin the settlement verifier to the persisted VK when one
            # exists for this deployment shape: the prover regenerating
            # its CRS can then no longer move what verification accepts
            # (the reference's on-chain verifier is a fixed contract,
            # contracts/EigenZkVM.json)
            if (
                args.final_wrap == "stark"
                and hasattr(settlement, "vk")
                and getattr(settlement, "vk", None) is None
            ):
                pinned = prover.pinned_vk(args.aggregator_addr)
                if pinned is not None:
                    settlement.vk = pinned
                    log.info("settlement verifier pinned to persisted VK")
        operator = Operator(
            db=db,
            chain=sequencer,
            settlement=settlement,
            prover=prover,
            worker_config=worker_config,
            aggregator_addr=args.aggregator_addr,
        )
        operator.run()

    def shutdown(*_):
        log.info("stopping")
        stop.set()
        if operator:
            operator.stop()
        if metrics_server:
            metrics_server.stop()
        server.stop()

    if not wait:
        # the caller drives shutdown through the returned handles
        return {"db": db, "sequencer": sequencer, "server": server,
                "operator": operator, "stop": stop, "shutdown": shutdown}
    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)
    stop.wait()
    shutdown()
    return 0


def cmd_prover(args, wait: bool = True):
    """Serve ProverService over gRPC, executing the L2 chain at --l2-addr
    (the reference's external eigen-prover role,
    scripts/launch-pos-eigen-zeth-node.sh:52-61).  With wait=False the
    started server is returned and the caller stops it."""
    from .protocol.grpc_shim import ProverServiceServer

    device = prover_device(args.device)
    l2_addr = args.l2_addr or global_env().l2_addr
    executor = ChainExecutor(JsonRpcClient(l2_addr))
    if args.stark_profile == "test":
        # tiny chunks, digest aggregation, the 2-constraint wrap
        prover = BatchProver(
            executor=executor, stark_params=stark.StarkParams(blowup=4, num_queries=2,
                                                              terminal_size=16),
            wrap="linear", chunk_trace_rows=16, recursion=False, crs_dir=args.crs_dir,
            device=device,
        )
    else:  # BatchProver's production defaults: 4,096-row chunks, recursion
        prover = BatchProver(executor=executor, wrap=args.final_wrap, crs_dir=args.crs_dir,
                             device=device)
    server = ProverServiceServer(prover, host=args.host, port=args.port).start()
    log.info("prover service listening on %s:%d (l2=%s, device=%s)", args.host, server.port,
             l2_addr, device)
    if not wait:
        return server
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()
    server.stop()
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if args.command == "run":
        return cmd_run(args)
    if args.command == "prover":
        return cmd_prover(args)
    if args.command == "init":
        return cmd_init(args)
    if args.command in ("chain-info", "config"):
        # parity with the reference's unimplemented!() stubs
        raise NotImplementedError(f"{args.command} is not implemented")
    return 1
