"""CLI — `python -m eigen_zeth_tpu_torch prover`, the port of the JAX
package's `prover` command (eigen_zeth_tpu/cli.py, `cmd_prover`).

`prover` runs the prover-network side of a deployment: it serves
ProverService over gRPC and proves on the card the blocks of the L2 it is
pointed at, so a node (the JAX package's `run --prover-addr`, the
reference's PROVER_ADDR) reaches the port.  It takes the JAX command's
arguments, and two more: `--device` (the card unless `--device cpu` is
given; a missing CUDA device stops the command) and `--crs-dir` (as the
JAX `run --crs-dir`).  The node's other commands are not ported.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading

import torch

from .models import stark
from .protocol.prover_service import BatchProver, ChainExecutor
from .settlement.ethereum import JsonRpcClient
from .utils.config import global_env

log = logging.getLogger("ezt.cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="eigen-zeth-tpu-torch")
    sub = p.add_subparsers(dest="command", required=True)

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
    prover.add_argument("--device", default="cuda",
                        help="torch device to prove on; the CPU only when asked "
                             "for with --device cpu")
    return p


def prover_device(name: str) -> torch.device:
    """The device the prover was asked for; a CUDA device that this process
    cannot reach stops the command rather than proving anywhere else."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"prover: device {name!r} asked for, but torch.cuda.is_available() "
                         "is False (pass --device cpu to prove on the CPU)")
    return device


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
    if args.command == "prover":
        return cmd_prover(args)
    return 1
