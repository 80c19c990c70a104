#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths (`eigen_zeth_tpu_torch`) on the card through
the entry points a user calls, and checks every stage:

  1. the card (nvidia-smi name and power limit), torch, CUDA and grpc versions
  2. builds the CUDA kernels from eigen_zeth_tpu_torch/csrc with nvcc and
     times the integer-rate probe beside the rate the bounds assume
  3. holds each kernel against its plain PyTorch version, bit for bit, at
     its path's shape (A and B at 32 windows x 1,326 MSM points, C and D at
     20 windows x 8,192 lanes, the power at 32 window sums and at 2^16,
     the fixed-base's batch, the G2 add at 32 windows x 896 points and at
     366,012, the stark wrap's phase-1 lane width, both timed; the point
     adds also under a mask, all set,
     none set and mixed, for both kept operands; kernel E, Poseidon2 over
     Goldilocks, through its four entry points: the sponge over the
     attestation trace's 2^21 rows of 216 columns as the AIR prover hands
     them over, column-major, and over FRI's 2^20 pairs, a Merkle level of
     2^20 strided digest pairs, 2^18 bare permutations with states aimed at
     the lazy field core's bounds, a whole 2^21-leaf tree in one launch and
     9 batched trees of 2^14 leaves, and its verifier-rows entry, which
     fills every Poseidon2 slot of the attestation's trace (32 queries, 147
     slots, 8 fold paths), against the plain fill on the host with plan
     words at and above p; kernel F, Poseidon2 over BN254 Fr,
     through its three entry points: the grind search's 2^14 states with
     edge lanes, the leaf sponge over the wrap attestation's 2^23 rows of
     216 columns, column-major, and its whole 2^23-leaf tree in one launch),
     with edge cases checked against host arithmetic; kernel G, the batched
     keccak256, at 0, 135, 136, 137 and 272 bytes against its plain version
     and the host, timed at 2^20 messages of 136 bytes.  Three times per kernel: at the path's shape
     (CUDA events around runs of back-to-back launches, median), the
     host's cost of a launch (host clock around 200 launches, nothing
     synchronised inside), and the device time at a batch where the card's
     work outlasts the host's enqueue, beside the bound worked out from
     the bytes and multiply-adds at that batch.  Checks that kernel C
     equals sign select, kernel D, restart select
  4. proves the two tiny golden configurations on the card (recursion off
     and on) and checks their sha256 digests against
     tests/data/torch_slice_golden.json; makes the CRS of the tiny STARK
     wrap and proves it, against tests/data/torch_stark_wrap_golden.json
  5. the batch proof, `BatchProver(wrap="mimc", recursion=False)`: 1,600
     synthetic blocks (2 chunks of 4,096-row traces), default StarkParams,
     the MiMC Groth16 wrap; checks every chunk proof with verify_chunk and
     the final proof with groth16.verify
  6. the fast G1 MSM at 2^18 distinct points, c = 13, serial 32, window
     group 32: `bad` is False, the result equals one host scalar
     multiplication of G by Σ s_i·k_i, kernel C was launched 32 times; then
     a small input with a duplicated point, where `bad` rises and the
     result still equals the host's
  7. KZG: a 4,096-point SRS made on the card, commit and opening of a
     4,096-coefficient polynomial, verify True, a wrong value False
  8. the unsafe mixed add through `bn254.point_madd_unsafe` (kernel D) on
     2^17 pairs of distinct points, against the complete add and the host
  9. the batch proof with recursive aggregation, as a node runs it:
     `BatchProver(recursion=True, wrap="mimc", mesh=...)` at the production chunk shape
     (4,096-row chunks, blowup 4, 32 queries, terminal 64, 30 queries of the
     attestation STARK), 1,600 synthetic blocks (2 chunks): step 3 attests
     each chunk with the verifier AIR (a 2^18-row trace of 216 columns,
     extended to 2^21, one Merkle tree over the wide rows) and is timed by
     stage; checks every chunk proof with verify_chunk, every attestation
     with recursion.verify_attestation under the pinned shape, the
     aggregated digest, the final proof with groth16.verify, and that
     kernel E was launched in steps 2 and 3, at most 60 times an
     attestation, its verifier-rows entry once an attestation; step 2 runs its 2 chunks over a 2-way chunk axis (logical
     shards over the cards) and must equal a serial step 2 byte for byte
 10. the node's default, sound final wrap at the node's configuration, as
     scripts/launch-devnet-torch.sh deploys it, in one process: the port's
     bridge service (`settlement/bridge_mock.py`, verify-batches checked
     under the pinned VK), the port's node (`cli.cmd_run` on `run
     --prover-addr ... --settlement custom --database native
     --verify-signatures --dev-fund`, auto-mine off, 0.2 s worker
     intervals, BRIDGE_SERVICE_ADDR at the bridge) and the prover process's own code (`cli.cmd_prover` on
     `prover --final-wrap stark --device cuda --l2-addr <the node>`) in this
     process, over loopback: ProverService over gRPC, `ChainExecutor`
     reading the node's eigenrpc, `BatchProver(recursion=True,
     wrap="stark")` with the production chunk shape and wrap profile (11
     queries, 12 grinding bits, blowup 32, two leaves).  `ensure_wrap_crs`
     first, on the server's prover, into a scratch directory, timed by
     stage; then 168 legacy transactions from L2_SEED, signed (EIP-155) with
     keys drawn from the seed, go in over eth_sendRawTransaction and one
     tick of the CL driver (`sequencer/cl_driver.py`:
     engine_forkchoiceUpdatedV3, getPayloadV3, newPayloadV3) seals them into
     block 1 (a packing of 2 chunks); the node's operator drives the four
     steps over the wire, settles the proof through the bridge and serves it
     with eigenrpc_getBatchProof.
     Each step's wall on the server (synchronised) and on the node, its
     launches and the bytes of its request and response; step 3 by stage,
     step 4 by part; the node's seconds to take the transactions in, to
     execute and seal the block, and from the seal to the proof served.
     Checks every transaction mined with status 1, every chunk proof, every
     wrap attestation with verify_attestation_wrap under the pinned
     profile, the payload's state roots against the node's
     eth_getBlockByNumber, the public input, the served proof equal to the
     server's, the bridge's record (accepted by its own groth16.verify under
     the pinned VK; a forged pi_c sent to it refused), the CL driver's
     payload the node's block, groth16.verify under the pinned
     VK, a forged pi_c rejected, a corrupted attestation giving
     COMPLETED_ERROR over the wire, GetStatus afterwards on a second client
     (STATUS_IDLE, the final step's request id), the device fixed-base
     against the host's on 2^14 G1 and 2^10 G2 scalars, kernel F
     launched in step 3 (at most F_STEP3_MOST times), and, after shutdown,
     the node's native database reopened by NativeDb and its log read by
     FileDb, both with the batch's proof, Finalized status and watermark
 11. the node's default topology, proving in process: `run --device cuda
     --final-wrap mimc` (no --prover-addr; recursion on at the production
     chunk shape), 36 signed transactions from NODE_SEED sealed into one
     block; checks the proof served by eigenrpc (the node's state roots,
     groth16.verify), the mock settlement's record, every receipt, and that
     kernels A, B and E were launched in the node's steps
 12. multi-device, after 8: a (chunk, domain) mesh over every card with at
     least 4 logical shards: `dryrun_multichip` at the path's sizes
     (`ntt_sharded` / `intt_sharded` at 2^20 Goldilocks elements bit for
     bit the one-device `ntt`, `msm_dist_g1` on the 2^18 points of 6 equal
     to the one-device `msm` and the host), `entry()`'s chunk-commit root
     equal to the same step on the CPU, under one `profile_trace` whose
     trace holds kernel E; within 15 s
 13. the batched keccak256 through `keccak.keccak256` on 2^20 messages of
     136 bytes (kernel G: no path of the node calls it, as in the JAX
     package), a sample held to the host

The transactions of 10 and 11 are signed on the host after the build.
Before each of the paths 5-13 the launch counts are set to
0, and read just after: every kernel of that path must have been launched,
and Montgomery multiplies must stay few (a power is one launch, not one per
squaring).
It prints a JSON line with each kernel's numbers, then, as its last line,
{"ok": true, "device": {...}}.  Any failed check raises; without a CUDA
device it exits non-zero before proving anything.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from eigen_zeth_tpu_torch.models import air, groth16, kzg, merkle, recursion, stark
from eigen_zeth_tpu_torch.ops import bn254, kernels, msm, poseidon
from eigen_zeth_tpu_torch.ops import goldilocks as gl
from eigen_zeth_tpu_torch.protocol import prover_service as ps
from eigen_zeth_tpu_torch.protocol.messages import ProofResultCode
from eigen_zeth_tpu_torch.settlement.ethereum import JsonRpcClient
from eigen_zeth_tpu_torch.utils import ethtx, secp256k1

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_slice_golden.json"
SLICE_BLOCKS = 1600  # 2 chunks (7,200 and 9 chunks cut for the time limit)
SLICE_CHUNKS = 2
MSM_POINTS = 1326  # variables of the MiMC wrap circuit
KERNEL_BATCH = 32 * MSM_POINTS  # 32 windows of c = 8 over the MSM's points
MSM_LOG2 = 18  # the fast MSM's size: 2^18 points
MSM_C, MSM_SERIAL, MSM_GROUP = 13, 32, 32
STEP_BATCH = 20 * (1 << MSM_LOG2) // MSM_SERIAL  # 20 windows x 8,192 lanes: kernel C's batch
POW_BATCH = 32  # window sums that one to_affine inverts
POW_SETUP_BATCH = 1 << 16  # the stark wrap's fixed-base chunk that one to_affine inverts
G2_POINTS = 896  # the wrap circuit's 884 G2 points, padded to full serial lanes
G2_BATCH = 32 * G2_POINTS
# the stark wrap's G2 MSM: 11,712,366 points padded to 11,712,384, over its
# 32 serial steps, is 366,012 lanes of phase 1
G2_WRAP_BATCH = 11_712_384 // 32
# batches for the device times: the card's work must outlast the host's
# enqueue, and the operands must not fit the 50 MB L2 cache
BIG_FIELD, BIG_POINT = 1 << 20, 1 << 18
KZG_SIZE = 4096  # coefficients of one EIP-4844 blob
# the recursion tier: 1,600 blocks are 2 chunks of 4,096 rows, one aggregation
# pair; the attestation trace's LDE is 2^21 rows of 216 columns
RECURSION_BLOCKS = 1600
ATT_ROWS, ATT_COLS = 1 << 21, 216
E_PLAIN_ROWS = 1 << 12  # rows of the wide matrix that the plain version hashes
E_PERM_BATCH = 1 << 18
E_EDGE = 256  # states of edge lanes among them
E_CHUNK_LEAVES = 1 << 14  # a chunk STARK's leaves: 4,096 rows at blowup 4
E_ATTESTATION_MOST = 60  # kernel E launches one attestation may take
ROWS_QUERIES = 32  # the child's queries: the periods of the attestation's trace
CHAIN_ID = 12345

# The card's peak rates for the bounds (NVIDIA H100 SXM data sheet): device
# memory 3.35 TB/s; 32-bit integer multiply-adds at a quarter of the
# 67 TFLOP/s float32 figure, which counts two operations per FMA on 128
# lanes per SM where the integer pipe has 64 lanes and one multiply-add each.
HBM_BYTES_PER_S = 3.35e12
INT32_MADS_PER_S = 67e12 / 4
MADS_PER_MONT_MUL = 8 * 8 + 8 * 8 + 8  # a·b, m·q and the eight m = t0·n0
MADS_PER_MONT_SQR = 36 + 8 * 8 + 8  # 28 cross terms once and 8 squares, then as above
# An Fq2 product on the G2 add's two lanes: on each lane a sum of two
# products and one reduction (csrc/bn254_field.cuh: mont_mul2_lanes); an Fq2
# squaring: one product on each lane.
MADS_PER_FQ2_MUL = 2 * (2 * 8 * 8 + 8 * 8 + 8)
MADS_PER_FQ2_SQR = 2 * MADS_PER_MONT_MUL
POW_EXPONENT = bn254.Q - 2  # Fermat inversion, the power the paths take
POW_PRODUCTS, POW_SQUARINGS = kernels.pow_chain(kernels.pow_schedule(POW_EXPONENT))
# per element: bytes moved (each (16,) int32 limb plane 64 B, each mask 4 B,
# inputs read once, outputs written once) and multiply-adds.  The point adds
# count the generic add, the least the function needs: 11 products and 5
# squarings.  For G2 and for the power the multiply-adds are those the
# kernel executes, not the least the function could take, so that the bound
# is the least time of the work each kernel does: an Fq2 product on two
# lanes is 400 multiply-adds and a squaring 272, where Karatsuba over full
# Fq products takes 408 and lazy Karatsuba (three products, two
# reductions) 336; the power counts the sliding-window chain the kernel runs
# on its exponent at kernels.POW_WINDOW bits (kernels.pow_chain: the
# table's products and squaring, each window's squarings and product; for
# q - 2, 55 products where 5 bits would take 53).  The mixed add of C and D
# is 7 products and 4 squarings.  Under a mask the passed elements move their 6
# (G2: 12) planes and take no product: `bound` scales the work by the share
# of elements that are added.
KERNEL_WORK = {
    "mont_mul": (3 * 64, MADS_PER_MONT_MUL),
    "point_add": (9 * 64, 11 * MADS_PER_MONT_MUL + 5 * MADS_PER_MONT_SQR),
    "point_scan_step": (8 * 64 + 3 * 4, 7 * MADS_PER_MONT_MUL + 4 * MADS_PER_MONT_SQR),
    "point_madd": (8 * 64 + 4, 7 * MADS_PER_MONT_MUL + 4 * MADS_PER_MONT_SQR),
    "mont_pow": (2 * 64, POW_PRODUCTS * MADS_PER_MONT_MUL + POW_SQUARINGS * MADS_PER_MONT_SQR),
    "point_add_g2": (18 * 64, 11 * MADS_PER_FQ2_MUL + 5 * MADS_PER_FQ2_SQR),
    "point_add_masked": (9 * 64 + 4, 11 * MADS_PER_MONT_MUL + 5 * MADS_PER_MONT_SQR),
    "point_add_g2_masked": (18 * 64 + 4, 11 * MADS_PER_FQ2_MUL + 5 * MADS_PER_FQ2_SQR),
}
# Kernel E: a Goldilocks product is four 32 x 32 wide multiply-adds (the
# 128-bit product; the fold is shifts, adds and compares), a squaring three
# (the cross product once).  A permutation is 736 products: 8 full rounds x
# 12 lanes x 4 and 22 partial rounds x (4 + 12), where each of the 118
# S-boxes (x^7 = x^4·x^3) squares twice: 236 squarings and 500 products.
MADS_PER_GL_MUL = 4
MADS_PER_GL_SQR = 3
GL_SQRS_PER_PERM = 2 * (8 * 12 + 22)
GL_MULS_PER_PERM = 8 * 12 * 4 + 22 * (4 + 12) - GL_SQRS_PER_PERM
MADS_PER_PERM = GL_MULS_PER_PERM * MADS_PER_GL_MUL + GL_SQRS_PER_PERM * MADS_PER_GL_SQR
# the wide multiply-add rate that the probe measures in this run (phase_build)
PROBED_MADS_PER_S = {"rate": INT32_MADS_PER_S}
AGGREGATOR = "0x" + "11" * 20
# Kernel F, Poseidon2 over BN254 Fr: 8 full rounds x 12 S-boxes and 68
# partial rounds x 1, each S-box x^5 = two Montgomery squarings and one
# product, and 68 x 12 products by the internal diagonal: 980 products and
# 328 squarings of 108 multiply-adds.  The 816 products by the diagonal are
# products by a constant below r, which Shoup's product does in 115
# multiply-adds (43 for the quotient, 36 each for the low halves of x·mu and
# q·r; csrc/poseidon2_fr.cuh); the other 164 are Montgomery products of 136:
# 151,568 multiply-adds, what the function needs (168,704 with every product
# a Montgomery one).  The conversions into and out of Montgomery form at the
# kernel's boundary and the linear layers' reductions are not counted.
FR_MULS_PER_PERM = 8 * 12 + 68 * (1 + 12)
FR_SQRS_PER_PERM = 2 * (8 * 12 + 68)
FR_CONST_MULS_PER_PERM = 68 * 12
MADS_PER_CONST_MUL = 43 + 2 * 36
MADS_PER_PERM_FR = ((FR_MULS_PER_PERM - FR_CONST_MULS_PER_PERM) * MADS_PER_MONT_MUL
                    + FR_CONST_MULS_PER_PERM * MADS_PER_CONST_MUL
                    + FR_SQRS_PER_PERM * MADS_PER_MONT_SQR)
# the wrap-profile attestation at the node's profile: the verifier AIR's
# 2^18 x 216 trace at blowup 32, LDE 2^23 rows, 72 packed Fr elements a row
WRAP_ROWS = 1 << 23
WRAP_PERMS_PER_ROW = -(-(ATT_COLS // 3) // 11)  # 72 packed elements at rate 11: 7
F_PLAIN_ROWS = 1 << 10  # rows the plain version hashes
F_PLAIN_LEAVES = 1 << 10  # leaves of the subtree the plain version commits
F_GRIND_BATCH = 1 << 14  # states of one batch of the card's grind search
F_BIG_PERM = 1 << 18
F_STEP3_MOST = 100  # kernel F launches step 3 may take (2 attestations)
STARK_GOLDEN = ROOT / "tests" / "data" / "torch_stark_wrap_golden.json"
# Kernel G, keccak256: a block is 24 rounds; as 32-bit operations with
# three-input logic (LOP3) and a 64-bit rotation as two funnel shifts, a round
# is 80 for theta (the column parities 20, the five rotations by one 10, the
# 25 lanes' two-way XOR with both parities 50), 48 for rho and pi (24
# rotations), 50 for chi (one LOP3 a half lane) and 2 for iota: 180.  Bytes:
# each message read once and its digest written once.
KECCAK_OPS_PER_BLOCK = 24 * (20 + 10 + 50 + 48 + 50 + 2)
KECCAK_MESSAGES, KECCAK_LEN = 1 << 20, 136  # the timed batch: two blocks a message
KECCAK_EDGE = (0, 135, 136, 137, 272)
KECCAK_CHECK = 4096  # messages of each edge length held to the plain version


# The node's block of the stark-wrap phase: L2_TXS legacy transactions, signed
# (EIP-155) with keys drawn from L2_SEED, whose packing (with the two state
# roots) is 2 chunks of 4,094 elements; the port's node seals them into block
# L2_BLOCK.  The in-process phase seals NODE_TXS from NODE_SEED.
L2_SEED = 20261017
L2_BLOCK = 1
L2_TXS = 168
NODE_SEED = 20261018
NODE_TXS = 36
SECP256K1_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
# calldata selectors: ERC-20 transfer and approve, Uniswap V2 swapExactTokensForTokens
ERC20_TRANSFER, ERC20_APPROVE, SWAP_EXACT = "a9059cbb", "095ea7b3", "38ed1739"


def l2_transactions(seed: int, n: int, chain_id: int = CHAIN_ID) -> list:
    """(transaction, key) of n legacy transactions from 12 senders whose keys
    are drawn from seed, each sender's nonces in order from 0: half ETH
    transfers, three tenths ERC-20 transfers, a tenth ERC-20 approvals and a
    tenth Uniswap V2 swaps, each with the gas its kind takes."""
    rng = np.random.default_rng(seed)

    def addr() -> str:
        return "0x" + rng.bytes(20).hex()

    def word(v: int) -> str:
        return f"{v:064x}"

    keys = [int.from_bytes(rng.bytes(32), "big") % (SECP256K1_N - 1) + 1 for _ in range(12)]
    senders = [secp256k1.priv_to_address(k).lower() for k in keys]
    tokens, router = [addr() for _ in range(4)], addr()
    nonces = [0] * len(keys)
    txs = []
    for _ in range(n):
        who = int(rng.integers(0, len(keys)))
        kind = rng.choice(["transfer", "erc20", "approve", "swap"], p=[0.5, 0.3, 0.1, 0.1])
        amount = int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1000))
        to, value, data, gas = addr(), amount, "", 21000
        if kind == "erc20":
            to, value, gas = tokens[int(rng.integers(0, 4))], 0, 65000
            data = ERC20_TRANSFER + word(int(addr(), 16)) + word(amount)
        elif kind == "approve":
            to, value, gas = tokens[int(rng.integers(0, 4))], 0, 46000
            data = ERC20_APPROVE + word(int(router, 16)) + word((1 << 256) - 1)
        elif kind == "swap":
            a, b = rng.choice(4, 2, replace=False)
            to, value, gas = router, 0, 180000
            data = (SWAP_EXACT + word(amount) + word(amount // 2) + word(0xA0)
                    + word(int(senders[who], 16)) + word(1_800_000_000) + word(2)
                    + word(int(tokens[a], 16)) + word(int(tokens[b], 16)))
        tx = {"nonce": hex(nonces[who]),
              "gasPrice": hex(int(rng.integers(1, 60)) * 10**9 + int(rng.integers(0, 10**9))),
              "gas": hex(gas), "to": to, "value": hex(value), "input": "0x" + data}
        nonces[who] += 1
        txs.append((tx, keys[who]))
    return txs


def sign_raw(job) -> bytes:
    """The raw signed bytes (eth_sendRawTransaction's) of one (tx, key)."""
    tx, key = job
    return ethtx.encode_signed_raw(ethtx.sign_legacy_tx(tx, CHAIN_ID, key), CHAIN_ID)


def run_node(tmp: str, *extra, database: str = "memory", settlement: str = "mock") -> dict:
    """`cli.cmd_run` on the parsed `run` command of a node that seals blocks
    when asked (auto-mine off), checks signatures and funds senders on first
    touch, with 0.2 s worker intervals, on the given database (native: a log
    under tmp) and settlement (custom: the bridge at BRIDGE_SERVICE_ADDR)."""
    from eigen_zeth_tpu_torch import cli

    conf = Path(tmp) / "worker.toml"
    conf.write_text("[settlement_worker_config]\nproof_interval = 0.2\nverify_interval = 0.2\n"
                    "rollup_interval = 0.2\nwatcher_interval = 0.2\n")
    return cli.cmd_run(cli.build_parser().parse_args([
        "run", "--database", database, "--db-path", str(Path(tmp) / "zeth.db"), "--settlement",
        settlement, "--rpc-port", "0", "--auto-mine-interval", "0", "--verify-signatures",
        "--dev-fund", "--worker-conf", str(conf), "--aggregator-addr", AGGREGATOR, *extra]),
        wait=False)


def node_and_prover_server(tmp: str, prover_args: list, **node_kw) -> tuple:
    """The port's node (`run_node`, `--prover-addr` at the server) and the
    prover server (`cli.cmd_prover` with `--l2-addr` at the node's
    eigenrpc), each on a port the system picks.  Each names the other, so
    the server's port is probed free first; if the server then cannot bind
    it (another process took it meanwhile), both start again on a new one."""
    import socket

    from eigen_zeth_tpu_torch import cli

    for _ in range(3):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        node = run_node(tmp, "--prover-addr", f"127.0.0.1:{port}", **node_kw)
        try:
            return node, cli.cmd_prover(cli.build_parser().parse_args([
                "prover", "--port", str(port), "--l2-addr",
                f"http://127.0.0.1:{node['server'].port}", *prover_args]), wait=False)
        except RuntimeError as exc:  # grpc: "Failed to bind to address ..."
            node["shutdown"]()
            log(f"[stark-wrap] the prover server could not bind port {port}: {exc}")
    raise AssertionError("the prover server found no free port in 3 tries")


def seal_and_prove(node: dict, raws: list, results: dict, deadline_s: float,
                   poll_s: float, seal=None, settled=None) -> dict:
    """Send the raw transactions over eth_sendRawTransaction, seal them into
    one block (`seal()`, by default through the node's Sequencer), and poll
    eigenrpc_getBatchProof every poll_s seconds until it serves the block's
    proof, then wait until the settlement has verified it (`settled()`: the
    state root it recorded, hex, or None; by default the mock settlement's).
    The poll is what a user of eigenrpc does; a few requests a second slowed
    the prover server's host work beside it, one every 5 s did not.  A step
    whose result is not COMPLETED_OK (results: step -> its last result)
    fails at once.  Returns the hashes, the served proof, the settled root
    and the times (the served time is late by at most poll_s)."""
    rpc = JsonRpcClient(f"http://127.0.0.1:{node['server'].port}", timeout=60.0).call
    if seal is None:
        seal = node["sequencer"].build_block
    if settled is None:
        mock = node["operator"].settlement
        settled = lambda: mock.verified[-1].new_state_root.hex() if mock.verified else None  # noqa: E731
    t = time.perf_counter()
    hashes = [rpc("eth_sendRawTransaction", ["0x" + raw.hex()]) for raw in raws]
    t_send = time.perf_counter() - t
    t = time.perf_counter()
    block = seal()
    t_seal = time.perf_counter() - t
    number = int(block["number"], 16)
    t = time.perf_counter()
    while not ((proof := rpc("eigenrpc_getBatchProof", [number])) and proof.get("proof")):
        for res in list(results.values()):
            _check(res)
        if time.perf_counter() - t > deadline_s:
            raise AssertionError(f"no proof of block {number} within {deadline_s} s")
        time.sleep(poll_s)
    t_served = time.perf_counter() - t
    while (root := settled()) is None or rpc("eigenrpc_getBlockByNumber", [hex(number)])[
            "status"] != "Finalized":
        if time.perf_counter() - t > deadline_s + 60:
            raise AssertionError(f"block {number} was not settled")
        time.sleep(0.05)
    t_settled = time.perf_counter() - t
    return {"rpc": rpc, "hashes": hashes, "block": block, "proof": proof,
            "settled_root": root, "send_s": t_send, "seal_s": t_seal,
            "served_s": t_served, "settled_s": t_settled}


def check_node_block(sealed: dict, n_txs: int) -> tuple:
    """Every transaction mined in the sealed block with status 1; the served
    proof's state roots are the node's own (eth_getBlockByNumber); the
    settlement recorded the block's state root.  Returns the parent and the
    block."""
    rpc, number = sealed["rpc"], int(sealed["block"]["number"], 16)
    parent = rpc("eth_getBlockByNumber", [hex(number - 1), False])
    block = rpc("eth_getBlockByNumber", [hex(number), False])
    if len(block["transactions"]) != n_txs:
        raise AssertionError(f"block {number} holds {len(block['transactions'])} of {n_txs} "
                             "transactions")
    statuses = {rpc("eth_getTransactionReceipt", [h])["status"] for h in sealed["hashes"]}
    if statuses != {"0x1"}:
        raise AssertionError(f"receipt statuses {statuses}, expected all 0x1")
    proof = sealed["proof"]
    if (proof["preStateRoot"], proof["postStateRoot"]) != (parent["stateRoot"],
                                                           block["stateRoot"]):
        raise AssertionError("the served proof's state roots are not the node's")
    if proof["blockNumber"] != number:
        raise AssertionError(f"eigenrpc served the proof of block {proof['blockNumber']}")
    if sealed["settled_root"] != block["stateRoot"][2:]:
        raise AssertionError("the settlement did not record the block's state root")
    return parent, block


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int, groups: int = 3) -> float:
    """Time of one fn() on the card in ms: the median over `groups` runs of
    `reps` back-to-back calls, each run between two CUDA events, after one
    warm-up call.  Back to back, the host's cost of enqueueing a call
    overlaps the card's work on the one before.  The inputs stay the same,
    so whatever fits the 50 MB L2 cache is found there."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_us_per_launch(fn, reps: int = 200) -> float:
    """The host's cost of one fn() in microseconds: host clock around `reps`
    calls with no synchronisation inside (the card works behind)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    secs = time.perf_counter() - t
    torch.cuda.synchronize()
    return secs / reps * 1e6


def random_limbs(n: int, device, seed: int) -> torch.Tensor:
    """(16, n) canonical Fq elements drawn on the card: uniform 16-bit limbs,
    the top limb below the modulus's."""
    gen = torch.Generator(device=device).manual_seed(seed)
    limbs = torch.randint(0, 1 << 16, (16, n), generator=gen, device=device, dtype=torch.int32)
    limbs[15] = limbs[15] % (bn254.Q >> 240)
    return limbs


def device_profile(tag: str, fn) -> None:
    """Run fn() once under torch.profiler and log the card's share of it:
    wall time, device busy time (the sum of the kernels' durations on the
    one stream), kernel count, and the five kernels with the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        log(f"[{tag}] profiler: no device activity recorded; busy share not measured")
        return
    busy = sum(r[1] for r in rows) / 1e6
    log(f"[{tag}] profiler: wall {wall:.4f} s (profiled), device busy {busy:.4f} s = "
        f"{100 * busy / wall:.1f}%, {sum(r[2] for r in rows)} device kernels")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:5]:
        log(f"[{tag}]   {us / 1e3:9.3f} ms  {count:6d} x  {key[:90]}")


def bound(name: str, n: int, added: float = 1.0, mads_per_s: float = INT32_MADS_PER_S) -> dict:
    """The least time the card could take for one launch of `name` on n
    elements: the larger of bytes over the memory rate and multiply-adds
    over the integer rate.  `added`: under a mask, the share of elements
    that are added; the others move two thirds of the planes (one operand
    in, out again) and take no product."""
    nbytes, mads = KERNEL_WORK[name]
    passed = (nbytes - 4) * 2 // 3 + 4  # the mask, one operand in, the output
    by_bytes = n * (added * nbytes + (1 - added) * passed) / HBM_BYTES_PER_S * 1e3
    by_ops = n * added * mads / mads_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None}  # no PyTorch call computes any of these functions


def timings(name: str, n: int, kernel, plain, plain_reps: int, big_n: int, big_kernel,
            added: float = 1.0) -> dict:
    """The three times of a kernel and its bounds: at the path's shape
    (kernel and plain version), the host's cost of a launch there, and the
    device time at the large batch with the bound at that batch."""
    big = bound(name, big_n, added)
    probed = bound(name, big_n, added, PROBED_MADS_PER_S["rate"])
    return {
        "shape": n, **bound(name, n, added),
        "ms": cuda_time_ms(kernel, 50),
        "plain_ms": cuda_time_ms(plain, plain_reps),
        "host_us_per_launch": host_us_per_launch(kernel),
        "device_batch": big_n,
        "device_ms": cuda_time_ms(big_kernel, 20),
        "device_bound_ms": big["bound_ms"],
        "device_bound_by": big["bound_by"],
        # the same bound with the multiply-add rate the probe measured
        "device_probed_bound_ms": probed["bound_ms"],
        "device_probed_bound_by": probed["bound_by"],
    }


def require_launches(path: str, launches: dict, names) -> None:
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {path} path")


def require_rows_once(path: str, launches: dict, attestations: int) -> None:
    """Step 3 filled each attestation's Poseidon2 rows with one launch of
    kernel E's verifier-rows entry."""
    if launches["poseidon2_rows"] != attestations:
        raise AssertionError(f"{launches['poseidon2_rows']} launches of poseidon2_rows in step 3 "
                             f"of the {path} path, expected one for each of {attestations} "
                             f"attestations")


def _check(result) -> None:
    if result.result_code != ProofResultCode.COMPLETED_OK:
        raise AssertionError(f"{type(result).__name__}: {result.error_message}")


class scratch_dir:
    """A fresh directory under the checkout's tmp/ (git ignores it), removed
    on exit: where the STARK wrap's CRS is made and read back."""

    def __enter__(self) -> str:
        import tempfile

        (ROOT / "tmp").mkdir(exist_ok=True)
        self.path = tempfile.mkdtemp(prefix="crs-", dir=ROOT / "tmp")
        return self.path

    def __exit__(self, *exc):
        import shutil

        shutil.rmtree(self.path, ignore_errors=True)
        return False


def timed_step(step: str, fn, times: dict, step_launches: dict | None):
    """fn() synchronised and timed into times[step]; its own launch counts
    into step_launches[step] where given."""
    before = dict(kernels.LAUNCHES)
    t = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    times[step] = time.perf_counter() - t
    if step_launches is not None:
        step_launches[step] = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
    return result


def drive(prover, blocks, step_launches: dict | None = None, aggregator: str = AGGREGATOR):
    """The four steps, in the order the node's state machine drives them;
    step 3 aggregates the first and last chunk proofs.  Every step is
    synchronised and timed; `step_launches`, where given, receives each
    step's own launch counts."""
    times = {}

    def run(step, fn):
        result = timed_step(step, fn, times, step_launches)
        _check(result)
        return result

    r1 = run("gen_batch_chunks", lambda: prover.gen_batch_chunks("smoke", blocks, CHAIN_ID, "evm"))
    r2 = run("gen_chunk_proof", lambda: prover.gen_chunk_proof(
        "smoke", r1.task_id, r1.chunk_count, CHAIN_ID, "evm", r1.batch_data))
    r3 = run("gen_aggregated_proof", lambda: prover.gen_aggregated_proof(
        "smoke", r2.chunk_proofs[0].proof, r2.chunk_proofs[-1].proof))
    r4 = run("gen_final_proof", lambda: prover.gen_final_proof(
        "smoke", r3.result_string, "BN128", aggregator))
    return r1, r2, r3, r4, times


def phase_environment() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — this run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    # the prover server's transport (phase 10); the module imports grpc itself,
    # with gRPC's fork handlers off (they aborted the forked Groth16 workers)
    from eigen_zeth_tpu_torch.protocol import grpc_shim

    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"grpc {grpc_shim.grpc.__version__} "
        f"(GRPC_ENABLE_FORK_SUPPORT={os.environ['GRPC_ENABLE_FORK_SUPPORT']})")


def phase_build(device) -> None:
    t = time.perf_counter()
    kernels.build()
    log(f"[build] kernels built in {time.perf_counter() - t:.1f} s")
    for line in kernels.ptxas_report().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
    # the integer rate the bounds assume, beside the card's: 8 blocks of 256
    # threads per SM; the bare wide multiply-add, then chains of Montgomery
    # products (136 multiply-adds each)
    blocks = 8 * torch.cuda.get_device_properties(device).multi_processor_count
    for mode, what, iters in ((0, "mad.wide.u32 on 8 accumulators per thread", 1 << 16),
                              (1, "Montgomery products, 2 chains per thread", 1 << 11)):
        mads, _ = kernels.imad_probe(device, mode, blocks, iters=iters)
        ms = cuda_time_ms(lambda: kernels.imad_probe(device, mode, blocks, iters=iters), 3)
        log(f"[probe] {what}: {mads} multiply-adds in {ms:.3f} ms = "
            f"{mads / ms / 1e9:.3f} T multiply-adds/s measured; the bounds assume "
            f"{INT32_MADS_PER_S / 1e12:.3f} T/s")
        if mode == 0:
            PROBED_MADS_PER_S["rate"] = mads / ms * 1e3


def _random_fq(rng, n: int) -> list[int]:
    return [int.from_bytes(rng.bytes(32), "little") % bn254.Q for _ in range(n)]


def _compare(name: str, got, ref) -> int:
    """Bit-for-bit equality of two tuples of tensors; returns the max abs
    err (0) or raises."""
    err = max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref))
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError(f"{name} disagrees with its plain version (max abs err {err})")
    return err


def _leaves(point) -> tuple:
    """The limb planes of a G1 point (3) or a G2 point (6), in order."""
    return tuple(t for coord in point for t in (coord if isinstance(coord, tuple) else (coord,)))


def _masks(rng, n: int, device):
    """All set, none set, mixed (non-zero values other than 1 included)."""
    mixed = torch.tensor(rng.integers(0, 2, n), dtype=torch.int32, device=device) * 5
    return torch.ones_like(mixed), torch.zeros_like(mixed), mixed


def _check_masked(name, add, plain, ctx, p, q, masks) -> int:
    """The masked add against its plain version for every mask and both kept
    operands; a fully passed operand must come out limb for limb."""
    err = 0
    for keep in (0, 1):
        for mask in masks:
            got = add(ctx, p, q, mask, keep)
            err = max(err, _compare(f"{name} (keep = {keep})", _leaves(got),
                                    _leaves(plain(ctx, p, q, mask, keep))))
        got = add(ctx, p, q, masks[0], keep)
        if not all(torch.equal(g, k) for g, k in zip(_leaves(got), _leaves((p, q)[keep]))):
            raise AssertionError(f"{name}: an all-set mask did not pass operand {keep} through")
    return err


def phase_kernels(device) -> dict:
    """Each kernel against its plain version on the same inputs, bit for bit."""
    rng = np.random.default_rng(2024)
    ctx = bn254.fq()
    Q = bn254.Q
    results = {}

    va, vb = _random_fq(rng, KERNEL_BATCH), _random_fq(rng, KERNEL_BATCH)
    va[:4], vb[:4] = [0, 1, Q - 1, Q - 2], [Q - 1, Q - 1, Q - 1, 0]
    a, b = ctx.from_int(va, device), ctx.from_int(vb, device)
    err = _compare("mont_mul", (kernels.mont_mul(ctx, a, b),), (kernels.mont_mul_plain(ctx, a, b),))
    _phase_carry_edges(device)
    big_a, big_b = random_limbs(BIG_FIELD, device, 1), random_limbs(BIG_FIELD, device, 2)
    results["mont_mul"] = {
        "max_abs_err": err,
        **timings("mont_mul", KERNEL_BATCH, lambda: kernels.mont_mul(ctx, a, b),
                  lambda: kernels.mont_mul_plain(ctx, a, b), 10,
                  BIG_FIELD, lambda: kernels.mont_mul(ctx, big_a, big_b)),
    }
    del big_a, big_b

    # real points for the degenerate cases: P+P, P+(-P), inf+P, P+inf
    pts = [bn254.h_ec_mul(k, bn254.G1_GEN) for k in range(1, 7)]
    P = pts + [pts[0], pts[1], None, pts[2], None]
    Qp = pts[::-1] + [pts[0], (pts[1][0], (-pts[1][1]) % Q), pts[3], None, None]

    def coords(points, n_rand):
        xs = [p[0] if p else 0 for p in points] + _random_fq(rng, n_rand)
        ys = [p[1] if p else 0 for p in points] + _random_fq(rng, n_rand)
        zs = [0 if p is None else 1 for p in points] + _random_fq(rng, n_rand)
        return tuple(ctx.from_int(v, device) for v in (xs, ys, zs))

    p = coords(P, KERNEL_BATCH - len(P))
    q = coords(Qp, KERNEL_BATCH - len(Qp))
    got3 = kernels.point_add(ctx, p, q)
    err = _compare("point_add", got3, kernels.point_add_plain(ctx, p, q))
    # the edge cases mean what they should: affine results against host math
    ax, ay = bn254.to_affine(bn254.FqOps(), bn254.PointJ(*(t[:, : len(P)] for t in got3)))
    xs, ys = ctx.to_int(ax), ctx.to_int(ay)
    for i, (u, v) in enumerate(zip(P, Qp)):
        want = bn254.h_ec_add(u, v)
        have = None if (want is None and xs[i] == 0 and ys[i] == 0) else (int(xs[i]), int(ys[i]))
        if have != want:
            raise AssertionError(f"point_add edge case {i} is wrong")
    big_p = tuple(random_limbs(BIG_POINT, device, 10 + k) for k in range(3))
    big_q = tuple(random_limbs(BIG_POINT, device, 20 + k) for k in range(3))
    results["point_add"] = {
        "max_abs_err": err,
        **timings("point_add", KERNEL_BATCH, lambda: kernels.point_add(ctx, p, q),
                  lambda: kernels.point_add_plain(ctx, p, q), 5,
                  BIG_POINT, lambda: kernels.point_add(ctx, big_p, big_q)),
    }
    masks = _masks(rng, KERNEL_BATCH, device)
    big_mask = _masks(rng, BIG_POINT, device)[2]
    added = 1.0 - float((masks[2] != 0).float().mean())
    results["point_add_masked"] = {
        "max_abs_err": _check_masked("point_add", kernels.point_add, kernels.point_add_plain,
                                     ctx, p, q, masks),
        **timings("point_add_masked", KERNEL_BATCH,
                  lambda: kernels.point_add(ctx, p, q, masks[2], 1),
                  lambda: kernels.point_add_plain(ctx, p, q, masks[2], 1), 5,
                  BIG_POINT, lambda: kernels.point_add(ctx, big_p, big_q, big_mask, 1),
                  added=added),
    }
    del big_p, big_q
    results.update(_phase_step_kernels(device, rng))
    results["mont_pow"] = _phase_pow_kernel(device, rng)
    results.update(_phase_g2_kernel(device, rng))
    poseidon2 = _phase_poseidon_kernel(device, rng)
    for name, r in results.items():
        log(f"[kernels] {name}: bit-exact vs plain at (16, {r.pop('shape')}); "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}; host "
            f"{r['host_us_per_launch']:.1f} us per launch; device {r['device_ms']:.4f} ms at "
            f"(16, {r['device_batch']}), bound {r['device_bound_ms']:.4f} ms by "
            f"{r['device_bound_by']} ({r['device_probed_bound_ms']:.4f} ms by "
            f"{r['device_probed_bound_by']} at the probed multiply-add rate)")
    log(f"[kernels] mont_pow at (16, {results['mont_pow']['setup_batch']}), the fixed-base's "
        f"to_affine: {results['mont_pow']['setup_ms']:.4f} ms, bit-exact against its plain "
        f"version; its chain on q - 2: "
        f"{POW_PRODUCTS} products and {POW_SQUARINGS} squarings (windows of "
        f"{kernels.POW_WINDOW} bits)")
    log(f"[kernels] point_add_g2 at (16, {results['point_add_g2']['wrap_batch']}), the stark "
        f"wrap's phase-1 lanes: {results['point_add_g2']['wrap_ms']:.4f} ms, bit-exact against "
        f"its plain version bare and under a mixed mask, the degenerate cases in the last "
        f"warp's tail")
    results["poseidon2"] = poseidon2
    results["poseidon2_rows"] = _phase_verifier_rows_kernel(device, rng)
    results["poseidon_fr"] = _phase_poseidon_fr_kernel(device, rng)
    results["keccak256"] = _phase_keccak_kernel(device, rng)
    return results


def keccak_bound(n: int, length: int, ops_per_s: float = INT32_MADS_PER_S) -> dict:
    """The least time the card could take for keccak256 of n messages of
    `length` bytes: the messages read and the digests written once against
    KECCAK_OPS_PER_BLOCK 32-bit integer operations a block."""
    blocks = length // 136 + 1
    by_bytes = n * (length + 32) / HBM_BYTES_PER_S * 1e3
    by_ops = n * blocks * KECCAK_OPS_PER_BLOCK / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _phase_keccak_kernel(device, rng) -> dict:
    """Kernel G against its plain version and `keccak256_host` at the rate's
    edge lengths, and against its plain version at the path's 2^20 messages
    of 136 bytes (two blocks each), bit for bit; there its times: `ms` and
    `device_ms` of the launch alone on the padded lanes, `plain_ms` of the
    plain version on the same lanes on the card, the host's cost of a launch
    on 1,024 contiguous messages."""
    from eigen_zeth_tpu_torch.ops import keccak

    err = 0
    for length in KECCAK_EDGE:
        msgs = torch.from_numpy(rng.integers(0, 256, (KECCAK_CHECK, length), dtype=np.uint8))
        lanes = keccak.pad_lanes(msgs.to(device))
        err = max(err, _compare(f"keccak256 ({length} bytes)", (kernels.keccak256_lanes(lanes),),
                                (keccak.absorb_plain(lanes),)))
        out = keccak.keccak256(msgs.to(device)).cpu().numpy()
        for i in (0, 1, KECCAK_CHECK - 1):
            if bytes(out[i]) != keccak.keccak256_host(bytes(msgs[i].numpy())):
                raise AssertionError(f"keccak256 differs from the host at {length} bytes")
    msgs = torch.randint(0, 256, (KECCAK_MESSAGES, KECCAK_LEN), dtype=torch.uint8, device=device)
    lanes = keccak.pad_lanes(msgs)
    bound = keccak_bound(KECCAK_MESSAGES, KECCAK_LEN)
    plain = []
    plain_ms = cuda_time_ms(lambda: plain.append(keccak.absorb_plain(lanes)), 1, 1)
    err = max(err, _compare(f"keccak256 ({KECCAK_MESSAGES} x {KECCAK_LEN} bytes)",
                            (kernels.keccak256_lanes(lanes),), (plain[-1],)))
    del plain
    ms = cuda_time_ms(lambda: kernels.keccak256_lanes(lanes), 20)
    small = lanes[:, :1024].contiguous()
    result = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None,
        "host_us_per_launch": host_us_per_launch(lambda: kernels.keccak256_lanes(small)),
        "device_batch": KECCAK_MESSAGES, "device_ms": ms,
        "device_bound_ms": bound["bound_ms"], "device_bound_by": bound["bound_by"],
        # the probe times the wide multiply-add, an instruction G never issues
        "device_probed_bound_ms": None, "device_probed_bound_by": None,
        "entry_ms": cuda_time_ms(lambda: keccak.keccak256(msgs), 5),
    }
    log(f"[kernels] keccak256: bit-exact vs plain and the host at {KECCAK_EDGE} bytes "
        f"({KECCAK_CHECK} messages each); {KECCAK_MESSAGES} messages of {KECCAK_LEN} bytes, "
        f"bit-exact vs plain: kernel {ms:.4f} ms, plain {result['plain_ms']:.4f} ms, bound {bound['bound_ms']:.4f} "
        f"ms by {bound['bound_by']}; host "
        f"{result['host_us_per_launch']:.1f} us per launch (1,024 messages); keccak256() with its padding "
        f"{result['entry_ms']:.4f} ms")
    return result


def phase_keccak(device) -> dict:
    """The batched keccak256 through its entry point, `keccak.keccak256`
    (no path of the node calls it, as in the JAX package): 2^20 messages of
    136 bytes from a seed, counts reset just before; a sample held to the host."""
    from eigen_zeth_tpu_torch.ops import keccak

    rng = np.random.default_rng(136)
    msgs = rng.integers(0, 256, (KECCAK_MESSAGES, KECCAK_LEN), dtype=np.uint8)
    on_card = torch.from_numpy(msgs).to(device)
    kernels.reset_launches()
    t = time.perf_counter()
    out = keccak.keccak256(on_card)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    require_launches("keccak256", launches, ("keccak256",))
    out = out.cpu().numpy()
    for i in rng.integers(0, KECCAK_MESSAGES, 16):
        if bytes(out[i]) != keccak.keccak256_host(bytes(msgs[i])):
            raise AssertionError(f"keccak256 of message {i} differs from the host")
    log(f"[keccak] keccak.keccak256 on {KECCAK_MESSAGES} messages of {KECCAK_LEN} bytes: "
        f"{secs * 1e3:.3f} ms (padding included), 16 digests equal to the host's; launches "
        f"{launches['keccak256']}")
    return launches


def poseidon_bound(rows: int, k_in: int, k_out: int, perms_per_row: int,
                   mads_per_s: float = INT32_MADS_PER_S) -> dict:
    """The least time the card could take for one launch of kernel E over
    `rows` rows: k_in words read and k_out written per row against
    perms_per_row permutations of MADS_PER_PERM wide multiply-adds."""
    by_bytes = rows * (k_in + k_out) * 8 / HBM_BYTES_PER_S * 1e3
    by_ops = rows * perms_per_row * MADS_PER_PERM / mads_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _random_gl(rng, shape, device) -> torch.Tensor:
    return gl.from_int(rng.integers(0, gl.P, shape, dtype=np.uint64), device)


def _phase_poseidon_kernel(device, rng) -> dict:
    """Kernel E's four entry points against their plain versions, bit for
    bit, at the shapes the provers give them, with edge values, row lengths
    and tree nodes checked against the host sponge and compression too."""
    P = gl.P
    err = 0

    def same(what, got, ref) -> None:
        nonlocal err
        err = max(err, _compare(f"poseidon2 {what}", (got,), (ref,)))

    def entry(rows, k_in, k_out, perms, kernel, plain, plain_rows, reps):
        big = poseidon_bound(rows, k_in, k_out, perms)
        probed = poseidon_bound(rows, k_in, k_out, perms, PROBED_MADS_PER_S["rate"])
        return {"rows": rows, "ms": cuda_time_ms(kernel, reps), "plain_ms": cuda_time_ms(plain, 1, 1),
                "plain_rows": plain_rows, **big,
                "probed_bound_ms": probed["bound_ms"], "probed_bound_by": probed["bound_by"]}

    # perm: 2^18 states; the first rows aim at the lazy core's bounds: every
    # lane 0, 1, p - 1 (which drives each partial round's mu_i·s_i towards
    # its maximum), p - 2^32, 2^32 - 1, 2^32, then random mixes of those
    states = _random_gl(rng, (E_PERM_BATCH, 12), device)
    edge = [0, 1, P - 1, P - (1 << 32), (1 << 32) - 1, 1 << 32]
    edge_rows = [[v] * 12 for v in edge] + [list(rng.choice(edge, 12)) for _ in range(E_EDGE - 6)]
    states[:E_EDGE] = gl.from_int(np.asarray(edge_rows, dtype=np.uint64), device)
    same("perm", poseidon.perm(states), poseidon.perm_plain(states))
    for i in range(0, E_EDGE, 3):
        if [int(v) for v in gl.to_int(poseidon.perm(states[i]))] != poseidon.perm_host(
                [int(v) for v in gl.to_int(states[i])]):
            raise AssertionError(f"poseidon2 perm differs from the host permutation (state {i})")
    flat = states[:E_EDGE].reshape(-1, 24)  # the edge words through the sponge
    same("hash_rows on edge words", poseidon.hash_elements(flat), poseidon.hash_elements_plain(flat))
    entries = {"perm": entry(E_PERM_BATCH, 12, 12, 1, lambda: poseidon.perm(states),
                             lambda: poseidon.perm_plain(states), E_PERM_BATCH, 5)}

    # hash_rows, edge rows: every length from 0 to 17 and 216, values 0, p - 1, random
    for k in (*range(18), ATT_COLS):
        rows = _random_gl(rng, (5, k), device)
        rows[0], rows[1] = 0, gl.as_i64(P - 1)
        got = poseidon.hash_elements(rows)
        same(f"hash_rows (k = {k})", got, poseidon.hash_elements_plain(rows))
        for i in (0, 1, 4):
            if [int(v) for v in gl.to_int(got[i])] != poseidon.hash_elements_host(
                    [int(v) for v in gl.to_int(rows[i])]):
                raise AssertionError(f"poseidon2 hash_rows differs from the host sponge (k = {k})")
    if poseidon.hash_elements(gl.zeros((0, 9), device)).shape != (0, 4):
        raise AssertionError("poseidon2 hash_rows of no rows is not (0, 4)")

    # hash_rows at the attestation's shape: the (216, 2^21) column matrix read
    # as rows through its strides.  The plain version takes the first and the
    # last E_PLAIN_ROWS rows (every row in full; hashing all 2^21 rows the plain
    # way is some 500 million small launches' worth of device memory traffic)
    cols = _random_gl(rng, (ATT_COLS, ATT_ROWS), device)
    wide = cols.T
    got = poseidon.hash_elements(wide)
    torch.cuda.synchronize()
    head, tail = slice(0, E_PLAIN_ROWS), slice(ATT_ROWS - E_PLAIN_ROWS, ATT_ROWS)
    for part in (head, tail):
        same("hash_rows on wide rows", got[part], poseidon.hash_elements_plain(wide[part]))
    same("hash_rows on a row-major copy", poseidon.hash_elements(wide[head].contiguous()), got[head])
    entries["hash_rows"] = entry(
        ATT_ROWS, ATT_COLS, 4, ATT_COLS // 8, lambda: poseidon.hash_elements(wide),
        lambda: poseidon.hash_elements_plain(wide[head]), E_PLAIN_ROWS, 3)
    del cols, wide, got

    # hash_rows on FRI's first layer of the attestation, 2^20 (u, v) pairs;
    # the chunk STARKs' batched leaves (K, m, 2) take the same route
    pairs = _random_gl(rng, (ATT_ROWS // 2, 2), device)
    same("hash_rows on pairs", poseidon.hash_elements(pairs), poseidon.hash_elements_plain(pairs))
    batched = pairs[: 2 * 16384].reshape(2, 16384, 2)
    same("hash_rows on batched pairs", poseidon.hash_elements(batched),
         poseidon.hash_elements(pairs[: 2 * 16384]).reshape(2, 16384, 4))
    entries["hash_rows_pairs"] = entry(
        ATT_ROWS // 2, 2, 4, 1, lambda: poseidon.hash_elements(pairs),
        lambda: poseidon.hash_elements_plain(pairs), ATT_ROWS // 2, 5)

    # hash_two: a Merkle level, the even and odd digests of 2^21 read in place
    level = _random_gl(rng, (ATT_ROWS, 4), device)
    level[0], level[1], level[2], level[3] = 0, 0, gl.as_i64(P - 1), gl.as_i64(P - 1)
    left, right = level[0::2], level[1::2]
    got = poseidon.hash_two(left, right)
    same("hash_two", got, poseidon.hash_two_plain(left, right))
    for i in (0, 1, 2):
        want = poseidon.hash_two_host([int(v) for v in gl.to_int(left[i])],
                                      [int(v) for v in gl.to_int(right[i])])
        if [int(v) for v in gl.to_int(got[i])] != want:
            raise AssertionError("poseidon2 hash_two differs from the host compression")
    entries["hash_two"] = entry(ATT_ROWS // 2, 8, 4, 1, lambda: poseidon.hash_two(left, right),
                                lambda: poseidon.hash_two_plain(left, right), ATT_ROWS // 2, 5)
    small = level[:2048]
    host_us = host_us_per_launch(lambda: poseidon.hash_two(small[0::2], small[1::2]))

    # the tree entry: the attestation's 2^21-leaf trace tree in one launch,
    # each level against the plain version, nodes at the bottom, the middle
    # and the top against the host compression; a batch of K = 9 trees of
    # 2^14 leaves (the chunk STARKs' batched commit) against the plain version
    before = kernels.LAUNCHES["poseidon2"]
    tree = merkle.commit_digests(level)
    launched = kernels.LAUNCHES["poseidon2"] - before
    if launched != 1:
        raise AssertionError(f"a 2^21-leaf tree took {launched} launches of kernel E, expected 1")
    for depth, (got, ref) in enumerate(zip(tree[1:], poseidon.merkle_levels_plain(level)), 1):
        same(f"tree level {depth}", got, ref)
    top = ATT_ROWS.bit_length() - 1
    for depth, i in ((1, 0), (1, ATT_ROWS // 2 - 1), (top // 2, 1), (top, 0)):
        kids = [[int(v) for v in gl.to_int(tree[depth - 1][2 * i + c])] for c in (0, 1)]
        if [int(v) for v in gl.to_int(tree[depth][i])] != poseidon.hash_two_host(*kids):
            raise AssertionError(f"tree node {i} of level {depth} differs from the host compression")
    chunks = _random_gl(rng, (9, E_CHUNK_LEAVES, 4), device)
    for got, ref in zip(poseidon.merkle_levels(chunks), poseidon.merkle_levels_plain(chunks)):
        same("tree entry on 9 batched trees", got, ref)
    entries["tree"] = entry(ATT_ROWS - 1, 4, 4, 1, lambda: merkle.commit_digests(level),
                            lambda: poseidon.merkle_levels_plain(level), ATT_ROWS - 1, 5)
    log(f"[kernels] poseidon2 tree: {ATT_ROWS} leaves in {launched} launch, every level equal "
        f"to the plain version, nodes equal to the host compression; 9 batched trees of "
        f"{E_CHUNK_LEAVES} leaves equal to the plain version")

    for name, e in entries.items():
        log(f"[kernels] poseidon2 {name}: bit-exact vs plain; {e['rows']} rows: kernel "
            f"{e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms on {e['plain_rows']} rows, bound "
            f"{e['bound_ms']:.4f} ms by {e['bound_by']} ({e['probed_bound_ms']:.4f} ms by "
            f"{e['probed_bound_by']} at the probed multiply-add rate)")
    log(f"[kernels] poseidon2: host {host_us:.1f} us per launch (hash_two on 1,024 pairs)")
    # the kernel's row: the sponge over the attestation's wide rows, where the
    # recursion path spends its hashing; device_ms is that launch's own time
    main = entries["hash_rows"]
    return {
        "max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "plain_rows": main["plain_rows"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "host_us_per_launch": host_us, "device_batch": ATT_ROWS, "device_ms": main["ms"],
        "device_bound_ms": main["bound_ms"], "device_bound_by": main["bound_by"],
        "device_probed_bound_ms": main["probed_bound_ms"],
        "device_probed_bound_by": main["probed_bound_by"],
        "entries": entries,
    }


def verifier_rows_bound(slots: int, queries: int, mads_per_s: float = INT32_MADS_PER_S) -> dict:
    """The least time the card could take for one fill of the verifier
    trace's Poseidon2 rows: the 48 columns of a slot's 32 rows written once
    for every slot and query, against one permutation for each."""
    states = slots * queries
    by_bytes = states * 32 * kernels.ROWS_COLS * 8 / HBM_BYTES_PER_S * 1e3
    by_ops = states * MADS_PER_PERM / mads_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _phase_verifier_rows_kernel(device, rng) -> dict:
    """Kernel E's verifier-rows entry against its plain version
    (`recursion._fill_perm_rows_plain`) on one plan at the node's shape (32
    queries, 147 slots, 8 fold paths), bit for bit, over a trace of random
    words: plan words 0, p - 1, p, p + 5 and 2^64 - 1 among random ones,
    whole input states of 0 and of p - 1.  Times: `ms` and `device_ms` of
    the launch alone (the plan already on the card), `plain_ms` of the plain
    fill on the host, the host's cost of a `fill_perm_rows` call (the plan's
    upload and the launch)."""
    P = gl.P
    sch = recursion.Schedule(4096, 64)
    plan = recursion.PermPlan.empty(sch, ROWS_QUERIES)
    if (plan.slots, len(plan.chains)) != (147, 4 + 8):
        raise AssertionError(f"not the node's plan: {plan.slots} slots, {len(plan.chains)} paths")
    words = rng.integers(0, P, plan.words.shape, dtype=np.uint64)
    mask = rng.random(words.shape) < 0.2
    words[mask] = rng.choice(np.asarray([0, P - 1, P, P + 5, (1 << 64) - 1], dtype=np.uint64),
                             int(mask.sum()))
    words[0, :, :12], words[1, :, :12] = 0, P - 1
    words[:, :, 16] = rng.integers(0, 2, words.shape[:2], dtype=np.uint64)
    plan.words[:] = words
    cols = recursion.Layout(4096, 64).n_cols
    host = rng.integers(0, P, (ROWS_QUERIES * plan.period, cols), dtype=np.uint64)
    trace = gl.from_int(host, device)
    t = time.perf_counter()
    recursion._fill_perm_rows_plain(host.reshape(ROWS_QUERIES, plan.period, cols), plan)
    plain_ms = (time.perf_counter() - t) * 1e3
    before = dict(kernels.LAUNCHES)
    recursion.fill_perm_rows(trace, plan)
    if (kernels.LAUNCHES["poseidon2_rows"] - before["poseidon2_rows"],
            kernels.LAUNCHES["poseidon2"] - before["poseidon2"]) != (1, 0):
        raise AssertionError("a fill of the verifier rows was not one launch of its own entry")
    got = gl.to_int(trace)
    if not (got == host).all():
        diff = np.argwhere(got != host)
        raise AssertionError(f"poseidon2_rows disagrees with its plain version at {len(diff)} "
                             f"words, the first (row, column) {tuple(diff[0])}")
    dev_words = torch.from_numpy(plan.words.reshape(-1).view(np.int64)).to(device)
    dev_words = dev_words.reshape(plan.words.shape)

    def launch():
        kernels.poseidon2_verifier_rows(trace, plan.period, dev_words, plan.chains)

    ms = cuda_time_ms(launch, 20)
    bound = verifier_rows_bound(plan.slots, ROWS_QUERIES)
    probed = verifier_rows_bound(plan.slots, ROWS_QUERIES, PROBED_MADS_PER_S["rate"])
    result = {
        "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None,
        "host_us_per_launch": host_us_per_launch(lambda: recursion.fill_perm_rows(trace, plan),
                                                 20),
        "device_batch": plan.slots * ROWS_QUERIES, "device_ms": ms,
        "device_bound_ms": bound["bound_ms"], "device_bound_by": bound["bound_by"],
        "device_probed_bound_ms": probed["bound_ms"], "device_probed_bound_by": probed["bound_by"],
    }
    log(f"[kernels] poseidon2_rows: bit-exact vs the plain fill at {ROWS_QUERIES} queries x "
        f"{plan.slots} slots ({len(plan.chains)} paths, {cols} columns), plan words at and "
        f"above p; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms on the host, bound "
        f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} ({probed['bound_ms']:.4f} ms by "
        f"{probed['bound_by']} at the probed multiply-add rate); host "
        f"{result['host_us_per_launch']:.1f} us per fill_perm_rows call")
    return result


def poseidon_fr_bound(rows: int, k_in: int, k_out: int, perms_per_row: int,
                      mads_per_s: float = INT32_MADS_PER_S) -> dict:
    """The least time the card could take for one launch of kernel F over
    `rows` rows: k_in words read and k_out written per row against
    perms_per_row permutations of MADS_PER_PERM_FR multiply-adds."""
    by_bytes = rows * (k_in + k_out) * 8 / HBM_BYTES_PER_S * 1e3
    by_ops = rows * perms_per_row * MADS_PER_PERM_FR / mads_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _phase_poseidon_fr_kernel(device, rng) -> dict:
    """Kernel F's three entry points against their plain versions, bit for
    bit, at the shapes the wrap-profile attestation gives them, with edge
    states and nodes against the host permutation, sponge and compression.
    Times: `ms` at the path's shape, `device_ms` at a large batch."""
    from eigen_zeth_tpu_torch.ops import poseidon_fr as pfr

    R, P = pfr.R, gl.P
    err = 0

    def same(what, got, ref) -> None:
        nonlocal err
        err = max(err, _compare(f"poseidon_fr {what}", (got,), (ref,)))

    def fr_ints(n):
        return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]

    def timed_plain(fn):
        """(fn(), its time in ms): the plain version is timed on the call
        that checks the kernel (a call of it costs seconds of launches)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def entry(rows, k_in, k_out, perms, ms, plain_ms, plain_rows, big_rows, big_ms):
        out = {"rows": rows, "ms": ms, "plain_ms": plain_ms, "plain_rows": plain_rows,
               **poseidon_fr_bound(rows, k_in, k_out, perms),
               "device_rows": big_rows, "device_ms": big_ms}
        for tag, r in (("device_", big_rows), ("device_probed_", big_rows), ("probed_", rows)):
            rate = PROBED_MADS_PER_S["rate"] if "probed" in tag else INT32_MADS_PER_S
            b = poseidon_fr_bound(r, k_in, k_out, perms, rate)
            out[tag + "bound_ms"], out[tag + "bound_by"] = b["bound_ms"], b["bound_by"]
        return out

    # perm: the grind search's batch, with edge states: every lane 0, 1,
    # r - 1, r - 2, 2^64 - 1, 2^192 - 1, or a value whose Montgomery form is
    # r - 1 or r - 2 (the top of what the lazy core is handed: its first
    # linear layer's sums at 64·(r - 1)), and mixes of them
    r_inv = pow(1 << 256, -1, R)
    edges = [0, 1, R - 1, R - 2, (1 << 64) - 1, (1 << 192) - 1,
             (R - 1) * r_inv % R, (R - 2) * r_inv % R]
    states = [[e] * 12 for e in edges] + [list(rng.choice(np.array(edges, dtype=object), 12))
                                          for _ in range(24)]
    states += [fr_ints(12) for _ in range(F_GRIND_BATCH - len(states))]
    words = pfr.words_from_ints(states, device)
    got = pfr.perm_device(words)
    plain, perm_plain_ms = timed_plain(lambda: pfr.perm_fr_plain(words))
    same("perm", got, plain)
    for i in (*range(len(edges)), *range(len(edges), 32, 3)):
        if pfr.ints_from_words(got[i]) != pfr.perm_host(states[i]):
            raise AssertionError(f"poseidon_fr perm differs from the host permutation (state {i})")
    big = pfr.words_from_ints([fr_ints(12) for _ in range(1024)], device).repeat(F_BIG_PERM // 1024, 1, 1)
    entries = {"perm": entry(F_GRIND_BATCH, 48, 48, 1,
                             cuda_time_ms(lambda: kernels.poseidon_fr_perm(words), 20),
                             perm_plain_ms, F_GRIND_BATCH,
                             F_BIG_PERM, cuda_time_ms(lambda: kernels.poseidon_fr_perm(big), 5))}
    host_us = host_us_per_launch(lambda: kernels.poseidon_fr_perm(words[:256]))
    del big

    # hash_rows, edge rows: lengths 1..13, 33, 34 and 216, values 0, p - 1, random
    for k in (*range(1, 14), 33, 34, ATT_COLS):
        rows = _random_gl(rng, (5, k), device)
        rows[0], rows[1] = 0, gl.as_i64(P - 1)
        got = kernels.poseidon_fr_hash_rows(rows)
        same(f"hash_rows (k = {k})", got, pfr.hash_rows_fr_plain(rows))
        for i in (0, 1, 4):
            row = [int(v) for v in gl.to_int(rows[i])]
            if pfr.ints_from_words(got[i])[0] != pfr.hash_elements_host(pfr.pack_gl_host(row)):
                raise AssertionError(f"poseidon_fr hash_rows differs from the host sponge (k = {k})")

    # hash_rows at the wrap attestation's shape: the (216, 2^23) LDE read as
    # rows through its strides; the plain version on the first F_PLAIN_ROWS
    # rows, the host sponge on rows at the far end
    gen = torch.Generator(device=device).manual_seed(7)
    cols = torch.randint(0, 1 << 62, (ATT_COLS, WRAP_ROWS), generator=gen, device=device)
    cols[:, :2] = gl.as_i64(P - 1)  # canonical words, the largest ones in the first rows
    wide = cols.T
    digests = kernels.poseidon_fr_hash_rows(wide)
    head = slice(0, F_PLAIN_ROWS)
    plain, rows_plain_ms = timed_plain(lambda: pfr.hash_rows_fr_plain(wide[head]))
    same("hash_rows on wide rows", digests[head], plain)
    last = [WRAP_ROWS - 1, WRAP_ROWS - F_PLAIN_ROWS]  # the far end, against the host sponge
    if pfr.ints_from_words(digests[last]) != [pfr.hash_elements_host(pfr.pack_gl_host(
            [int(v) for v in gl.to_int(wide[i])])) for i in last]:
        raise AssertionError("poseidon_fr hash_rows differs from the host sponge at the far end")
    wide_ms = cuda_time_ms(lambda: kernels.poseidon_fr_hash_rows(wide), 1)
    entries["hash_rows"] = entry(
        WRAP_ROWS, ATT_COLS, 4, WRAP_PERMS_PER_ROW, wide_ms,
        rows_plain_ms, F_PLAIN_ROWS,
        WRAP_ROWS, wide_ms)
    del cols, wide

    # merkle_levels: the trace tree over 2^23 leaf digests in one launch, every
    # level of a subtree of F_PLAIN_LEAVES leaves against the plain version,
    # nodes against the host compression
    before = kernels.LAUNCHES["poseidon_fr"]
    tree = kernels.poseidon_fr_merkle_levels(digests)
    if kernels.LAUNCHES["poseidon_fr"] - before != 1:
        raise AssertionError("a 2^23-leaf Fr tree took more than one launch of kernel F")
    small = digests[:F_PLAIN_LEAVES]
    plain, tree_plain_ms = timed_plain(lambda: pfr.merkle_levels_fr_plain(small))
    for depth, (got, ref) in enumerate(zip(kernels.poseidon_fr_merkle_levels(small), plain), 1):
        same(f"tree level {depth}", got, ref)
        if not torch.equal(got, tree[depth - 1][: got.shape[0]]):
            raise AssertionError(f"the 2^23-leaf tree's level {depth} differs from its subtree's")
    top = WRAP_ROWS.bit_length() - 1
    levels = [digests] + tree
    for depth, i in ((1, 0), (1, WRAP_ROWS // 2 - 1), (top // 2, 3), (top, 0)):
        kids = pfr.ints_from_words(levels[depth - 1][2 * i : 2 * i + 2])
        if pfr.ints_from_words(levels[depth][i : i + 1]) != [pfr.hash_two_host(*kids)]:
            raise AssertionError(f"Fr tree node {i} of level {depth} differs from the host")
    tree_ms = cuda_time_ms(lambda: kernels.poseidon_fr_merkle_levels(digests), 1)
    entries["merkle_levels"] = entry(
        WRAP_ROWS - 1, 4, 4, 1, tree_ms,
        tree_plain_ms, F_PLAIN_LEAVES - 1,
        WRAP_ROWS - 1, tree_ms)
    del digests, tree, levels

    for name, e in entries.items():
        log(f"[kernels] poseidon_fr {name}: bit-exact vs plain; {e['rows']} rows: kernel "
            f"{e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms on {e['plain_rows']} rows, bound "
            f"{e['bound_ms']:.4f} ms by {e['bound_by']} ({e['probed_bound_ms']:.4f} ms at the "
            f"probed rate); {e['device_rows']} rows: {e['device_ms']:.4f} ms, bound "
            f"{e['device_bound_ms']:.4f} ms ({e['device_probed_bound_ms']:.4f} ms probed)")
    log(f"[kernels] poseidon_fr: host {host_us:.1f} us per launch (perm on 256 states); "
        f"{MADS_PER_PERM_FR} multiply-adds a permutation")
    # the kernel's row: the leaf sponge over the wrap attestation's wide rows
    main = entries["hash_rows"]
    return {
        "max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "plain_rows": main["plain_rows"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "host_us_per_launch": host_us, "device_batch": WRAP_ROWS, "device_ms": main["device_ms"],
        "device_bound_ms": main["device_bound_ms"], "device_bound_by": main["device_bound_by"],
        "device_probed_bound_ms": main["device_probed_bound_ms"],
        "device_probed_bound_by": main["device_probed_bound_by"],
        "entries": entries,
    }


def _phase_carry_edges(device) -> None:
    """The field core on operands that stress its carry chains (words of all
    ones, q - 1, R mod q and their like), every pairing, for Fq and Fr:
    product against the plain version and against python ints, and the
    dedicated squaring (mont_pow with exponent 2) against the product."""
    words = [0, 1, 2, (1 << 256) - 1, (1 << 255) - 1, (1 << 224) - 1, 0xFFFFFFFF,
             0xFFFFFFFF << 224, 1 << 255, 1 << 128]
    for modulus in (bn254.Q, bn254.R):
        ctx = bn254.mont_ctx(modulus)
        vals = sorted({w % modulus for w in words}
                      | {modulus - 1, modulus - 2, ctx.R_mod, ctx.R2_mod, modulus >> 1})
        a = ctx.from_int([x for x in vals for _ in vals], device, mont=False)
        b = ctx.from_int([y for _ in vals for y in vals], device, mont=False)
        got = kernels.mont_mul(ctx, a, b)
        _compare("mont_mul on carry edges", (got,), (kernels.mont_mul_plain(ctx, a, b),))
        rinv = pow(ctx.R, -1, modulus)
        want = [x * y * rinv % modulus for x in vals for y in vals]
        if list(ctx.to_int(got, mont=False)) != want:
            raise AssertionError("mont_mul on carry edges differs from python ints")
        if not torch.equal(kernels.mont_pow(ctx, a, 2), kernels.mont_mul(ctx, a, a)):
            raise AssertionError("the squaring differs from the product on carry edges")
    log("[kernels] field core on carry-edge operands (Fq and Fr): product equals the plain "
        "version and python ints, squaring equals product")


def _phase_pow_kernel(device, rng) -> dict:
    """`mont_pow` against its plain version and python's pow, Fq and Fr, on
    0, 1, q - 1 and random values, exponents 0, 1, 2, the window's edges
    2^w - 1, 2^w, 2^w + 1, q - 2 and random; at (16, 2^16), the fixed-base's
    batch, against its plain version to q - 2 and timed."""
    err = 0
    w = kernels.POW_WINDOW
    for modulus in (bn254.Q, bn254.R):
        ctx = bn254.mont_ctx(modulus)
        vals = [0, 1, modulus - 1] + [v % modulus for v in _random_fq(rng, POW_BATCH - 3)]
        a = ctx.from_int(vals, device)
        for e in (0, 1, 2, (1 << w) - 1, 1 << w, (1 << w) + 1, modulus - 2,
                  int.from_bytes(rng.bytes(32), "little")):
            got = kernels.mont_pow(ctx, a, e)
            err = max(err, _compare(f"mont_pow (exponent {e})", (got,),
                                    (kernels.mont_pow_plain(ctx, a, e),)))
            if list(ctx.to_int(got)) != [pow(v, e, modulus) for v in vals]:
                raise AssertionError(f"mont_pow differs from python's pow (exponent {e})")
    ctx = bn254.fq()
    a = ctx.from_int(_random_fq(rng, POW_BATCH), device)
    big_a = random_limbs(BIG_POINT, device, 3)
    setup_a = random_limbs(POW_SETUP_BATCH, device, 4)
    err = max(err, _compare(f"mont_pow at (16, {POW_SETUP_BATCH})",
                            (kernels.mont_pow(ctx, setup_a, POW_EXPONENT),),
                            (kernels.mont_pow_plain(ctx, setup_a, POW_EXPONENT),)))
    return {
        "max_abs_err": err,
        **timings("mont_pow", POW_BATCH, lambda: kernels.mont_pow(ctx, a, POW_EXPONENT),
                  lambda: kernels.mont_pow_plain(ctx, a, POW_EXPONENT), 1,
                  BIG_POINT, lambda: kernels.mont_pow(ctx, big_a, POW_EXPONENT)),
        "setup_batch": POW_SETUP_BATCH,
        "setup_ms": cuda_time_ms(lambda: kernels.mont_pow(ctx, setup_a, POW_EXPONENT), 20),
        "products": POW_PRODUCTS,
        "squarings": POW_SQUARINGS,
    }


def _phase_g2_kernel(device, rng) -> dict:
    """The G2 add, plain and masked, against its plain version, with the
    degenerate cases on real G2 points checked against host arithmetic; at
    the stark wrap's phase-1 width (366,012), with those cases in the last
    warp's tail, against its plain version too, bare and under a mixed mask
    for both kept operands, and timed bare."""
    ctx = bn254.fq()
    H2 = bn254.HOST_FQ2
    G2 = (bn254.G2_GEN_X, bn254.G2_GEN_Y)
    pts = [bn254.h_ec_mul(k, G2, H2) for k in range(1, 7)]
    P = pts + [pts[0], pts[1], None, pts[2], None]  # ..., P+P, P+(-P), inf+P, P+inf, inf+inf
    Qp = pts[::-1] + [pts[0], (pts[1][0], H2.neg(pts[1][1])), pts[3], None, None]
    n = G2_BATCH

    def coords(points):
        m = n - len(points)
        xy = [tuple(ctx.from_int([pt[c][j] if pt else 0 for pt in points] + _random_fq(rng, m),
                                 device) for j in range(2)) for c in range(2)]
        z0 = ctx.from_int([0 if pt is None else 1 for pt in points] + _random_fq(rng, m), device)
        z1 = ctx.from_int([0] * len(points) + _random_fq(rng, m), device)
        return (*xy, (z0, z1))

    p, q = coords(P), coords(Qp)
    got = kernels.point_add_g2(ctx, p, q)
    err = _compare("point_add_g2", _leaves(got), _leaves(kernels.point_add_g2_plain(ctx, p, q)))
    F2 = bn254.Fq2Ops()
    head = bn254.PointJ(*(tuple(t[:, : len(P)].contiguous() for t in c) for c in got))
    (x0, x1), (y0, y1) = (F2.to_int(c) for c in bn254.to_affine(F2, head))
    for i, (u, v) in enumerate(zip(P, Qp)):
        want = bn254.h_ec_add(u, v, H2) or ((0, 0), (0, 0))
        if ((int(x0[i]), int(x1[i])), (int(y0[i]), int(y1[i]))) != want:
            raise AssertionError(f"point_add_g2 edge case {i} is wrong")

    def big_point(seed):
        return tuple((random_limbs(BIG_POINT, device, seed + 2 * c),
                      random_limbs(BIG_POINT, device, seed + 2 * c + 1)) for c in range(3))

    def wrap_point(seed, head):
        """G2_WRAP_BATCH random elements that end in head's degenerate cases:
        366,012 leaves 12 pairs in the last warp, so they fall in its tail."""
        return tuple(tuple(torch.cat((random_limbs(G2_WRAP_BATCH - len(P), device, seed + 2 * c + j),
                                      head[c][j][:, : len(P)]), dim=1) for j in range(2))
                     for c in range(3))

    big_p, big_q = big_point(30), big_point(40)
    wrap_p, wrap_q = wrap_point(50, p), wrap_point(60, q)
    err = max(err, _compare(f"point_add_g2 at (16, {G2_WRAP_BATCH})",
                            _leaves(kernels.point_add_g2(ctx, wrap_p, wrap_q)),
                            _leaves(kernels.point_add_g2_plain(ctx, wrap_p, wrap_q))))
    out = {"point_add_g2": {
        "max_abs_err": err,
        **timings("point_add_g2", n, lambda: kernels.point_add_g2(ctx, p, q),
                  lambda: kernels.point_add_g2_plain(ctx, p, q), 3,
                  BIG_POINT, lambda: kernels.point_add_g2(ctx, big_p, big_q)),
        "wrap_batch": G2_WRAP_BATCH,
        "wrap_ms": cuda_time_ms(lambda: kernels.point_add_g2(ctx, wrap_p, wrap_q), 20),
    }}
    masks = _masks(rng, n, device)
    big_mask = _masks(rng, BIG_POINT, device)[2]
    wrap_mask = _masks(rng, G2_WRAP_BATCH, device)[2]
    err = _check_masked("point_add_g2", kernels.point_add_g2, kernels.point_add_g2_plain,
                        ctx, p, q, masks)
    for keep in (0, 1):
        err = max(err, _compare(f"point_add_g2 at (16, {G2_WRAP_BATCH}) (keep = {keep})",
                                _leaves(kernels.point_add_g2(ctx, wrap_p, wrap_q, wrap_mask, keep)),
                                _leaves(kernels.point_add_g2_plain(ctx, wrap_p, wrap_q,
                                                                   wrap_mask, keep))))
    del wrap_p, wrap_q, wrap_mask
    added = 1.0 - float((masks[2] != 0).float().mean())
    out["point_add_g2_masked"] = {
        "max_abs_err": err,
        **timings("point_add_g2_masked", n,
                  lambda: kernels.point_add_g2(ctx, p, q, masks[2], 0),
                  lambda: kernels.point_add_g2_plain(ctx, p, q, masks[2], 0), 3,
                  BIG_POINT, lambda: kernels.point_add_g2(ctx, big_p, big_q, big_mask, 0),
                  added=added),
    }
    return out


def _phase_step_kernels(device, rng) -> dict:
    """Kernels C and D at the fast MSM's step batch, against their plain
    versions and against each other."""
    ctx = bn254.fq()
    Q = bn254.Q
    n = STEP_BATCH
    pts = [bn254.h_ec_mul(k, bn254.G1_GEN) for k in range(1, 5)]
    neg = lambda p: (p[0], (-p[1]) % Q)  # noqa: E731
    P = pts[0]
    edge = [  # (accumulator, point, sign, flag, bad of C, bad of D)
        ((0, 0, 0), pts[1], 0, 1, 0, 1),        # all-zero accumulator under a flag
        ((0, 0, 0), pts[1], 1, 1, 0, 1),
        (P + (1,), P, 0, 0, 1, 1),              # P + P
        (P + (1,), neg(P), 0, 0, 1, 1),         # P + (-P)
        (P + (1,), P, 1, 0, 1, 1),              # the sign makes it P + (-P)
        (pts[2] + (0,), pts[3], 0, 0, 1, 1),    # accumulator at infinity
        (P + (1,), P, 0, 1, 0, 1),              # the same three under a flag
        (P + (1,), neg(P), 0, 1, 0, 1),
        (pts[2] + (0,), pts[3], 1, 1, 0, 1),
        (pts[2] + (1,), (pts[3][0], 0), 1, 0, 0, 0),  # y = 0 and sign set
        (pts[2] + (1,), (pts[3][0], 0), 1, 1, 0, 0),
        (pts[0] + (1,), pts[1], 0, 0, 0, 0),    # honest adds: G + 2G, G - 2G
        (pts[0] + (1,), pts[1], 1, 0, 0, 0),
    ]
    m = n - len(edge)
    cols = [[e[0][k] for e in edge] + _random_fq(rng, m) for k in range(3)]
    cols += [[e[1][k] for e in edge] + _random_fq(rng, m) for k in range(2)]
    ax, ay, az, bx, by = (ctx.from_int(c, device) for c in cols)
    sgn = torch.tensor([e[2] for e in edge] + rng.integers(0, 2, m).tolist(),
                       dtype=torch.int32, device=device)
    flg = torch.tensor([e[3] for e in edge] + rng.integers(0, 2, m).tolist(),
                       dtype=torch.int32, device=device)
    acc, q_aff = (ax, ay, az), (bx, by)

    got_c = kernels.point_scan_step(ctx, acc, q_aff, sgn, flg)
    err_c = _compare("point_scan_step", got_c,
                     kernels.point_scan_step_plain(ctx, acc, q_aff, sgn, flg))
    got_d = kernels.point_madd(ctx, acc, q_aff)
    err_d = _compare("point_madd", got_d, kernels.point_madd_plain(ctx, acc, q_aff))
    torch.cuda.synchronize()

    # the edge cases mean what they should
    k = len(edge)
    if got_c[3][:k].tolist() != [e[4] for e in edge] or got_d[3][:k].tolist() != [e[5] for e in edge]:
        raise AssertionError("bad planes of the edge cases are wrong")
    one = ctx.one_mont((1,), device)[:, 0]
    if not (torch.equal(got_c[2][:, 0], one) and int(got_c[1][:, 10].abs().sum()) == 0):
        raise AssertionError("restart under a flag, or -0 = 0, is wrong")
    F = bn254.FqOps()
    hx, hy = bn254.to_affine(F, bn254.PointJ(*(t[:, 11:13].contiguous() for t in got_c[:3])))
    have = list(zip(map(int, ctx.to_int(hx)), map(int, ctx.to_int(hy))))
    if have != [bn254.h_ec_add(pts[0], pts[1]), bn254.h_ec_add(pts[0], neg(pts[1]))]:
        raise AssertionError("the scan step's honest adds are not the curve's")

    # kernel C == sign select, then kernel D, then the restart select
    negate, restart = sgn != 0, flg != 0
    qy2 = torch.where(negate, ctx.neg(by), by)
    dx, dy, dz, dbad = kernels.point_madd(ctx, acc, (bx, qy2))
    composed = (torch.where(restart, bx, dx), torch.where(restart, qy2, dy),
                torch.where(restart, one[:, None], dz), dbad * (1 - flg))
    if not all(torch.equal(g, r) for g, r in zip(got_c, composed)):
        raise AssertionError("kernel C differs from select, kernel D, restart")
    log(f"[kernels] point_scan_step == sign select + point_madd + restart select at (16, {n})")

    big = tuple(random_limbs(BIG_POINT, device, 50 + k) for k in range(5))
    big_sgn, big_flg = (_masks(rng, BIG_POINT, device)[2] for _ in range(2))
    return {
        "point_scan_step": {
            "max_abs_err": err_c,
            **timings("point_scan_step", n,
                      lambda: kernels.point_scan_step(ctx, acc, q_aff, sgn, flg),
                      lambda: kernels.point_scan_step_plain(ctx, acc, q_aff, sgn, flg), 5,
                      BIG_POINT,
                      lambda: kernels.point_scan_step(ctx, big[:3], big[3:], big_sgn, big_flg)),
        },
        "point_madd": {
            "max_abs_err": err_d,
            **timings("point_madd", n, lambda: kernels.point_madd(ctx, acc, q_aff),
                      lambda: kernels.point_madd_plain(ctx, acc, q_aff), 5,
                      BIG_POINT, lambda: kernels.point_madd(ctx, big[:3], big[3:])),
        },
    }


def _sha(s: str) -> str:
    return hashlib.sha256(s.encode()).hexdigest()


def phase_golden(device) -> None:
    """The two tiny configurations of the golden file on the card: recursion
    off, and the recursion tier (two attestation STARKs in step 3)."""
    golden = json.loads(GOLDEN.read_text())
    for name, entry in (("recursion off", golden), ("recursion on", golden["recursion"])):
        cfg = entry["config"]
        prover = ps.BatchProver(
            stark_params=stark.StarkParams(**cfg["stark_params"]),
            wrap=cfg["wrap"],
            recursion=cfg["recursion"],
            chunk_trace_rows=cfg["chunk_trace_rows"],
            agg_queries=cfg.get("agg_queries", 30),
            groth16_seed=cfg["groth16_seed"],
            device=device,
        )
        t = time.perf_counter()
        prover.verifying_key  # the deterministic MiMC CRS, once per process
        log(f"[golden] Groth16 CRS setup (MiMC wrap): {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        _, r2, r3, r4, _ = drive(prover, cfg["blocks"])
        got = {
            "chunk_proofs": [_sha(c.proof) for c in r2.chunk_proofs],
            "aggregated": _sha(r3.result_string),
            "final_proof": _sha(r4.final_proof.proof),
            "public_input": _sha(r4.final_proof.public_input),
        }
        if got != entry["sha256"]:
            raise AssertionError(f"golden mismatch ({name}): {got} != {entry['sha256']}")
        log(f"[golden] tiny configuration, {name}, on the card in {time.perf_counter() - t:.2f} s: "
            "all sha256 digests match")
    phase_golden_stark_wrap(device)


def stark_wrap_prover(cfg: dict, crs_dir: str, device) -> ps.BatchProver:
    return ps.BatchProver(
        stark_params=stark.StarkParams(**cfg["stark_params"]),
        chunk_trace_rows=cfg["chunk_trace_rows"], agg_queries=cfg["agg_queries"], wrap="stark",
        wrap_queries=cfg["wrap_queries"], wrap_grind_bits=cfg["wrap_grind_bits"],
        wrap_blowup=cfg["wrap_blowup"], max_wrap_leaves=cfg["max_wrap_leaves"],
        groth16_seed=cfg["groth16_seed"], crs_dir=crs_dir, device=device,
    )


def phase_golden_stark_wrap(device) -> None:
    """The tiny stark-wrap configuration of tests/data/torch_stark_wrap_golden.json
    on the card: its CRS made into a fresh directory, the four steps, every
    sha256 digest the JAX package's."""
    golden = json.loads(STARK_GOLDEN.read_text())
    cfg = golden["config"]
    with scratch_dir() as crs_dir:
        prover = stark_wrap_prover(cfg, crs_dir, device)
        t = time.perf_counter()
        prover.ensure_wrap_crs(cfg["aggregator_addr"])
        t_crs = time.perf_counter() - t
        _, r2, r3, r4, times = drive(prover, cfg["blocks"], aggregator=cfg["aggregator_addr"])
    got = {
        "chunk_proofs": [_sha(c.proof) for c in r2.chunk_proofs],
        "aggregated": _sha(r3.result_string),
        "final_proof": _sha(r4.final_proof.proof),
        "public_input": _sha(r4.final_proof.public_input),
    }
    if got != golden["sha256"]:
        raise AssertionError(f"golden mismatch (stark wrap): {got} != {golden['sha256']}")
    log(f"[golden] tiny configuration, stark wrap, on the card: CRS {t_crs:.2f} s, four steps "
        f"{sum(times.values()):.2f} s: all sha256 digests match")


def require_at_most(path: str, launches: dict, name: str, most: int) -> None:
    if launches[name] > most:
        raise AssertionError(f"{launches[name]} launches of {name} on the {path} path, "
                             f"expected at most {most}")


# step 4's parts under the mimc wrap: the proof, each MSM inside it, verify
STEP4_PARTS = ((msm, "msm_g1"), (msm, "msm_g2"), (groth16, "prove"), (groth16, "verify"))


def phase_slice(device) -> dict:
    prover = ps.BatchProver(wrap="mimc", recursion=False, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    steps = {}
    kernels.reset_launches()
    with timed_funcs(STEP4_PARTS) as calls:
        r1, r2, r3, r4, times = drive(prover, list(range(1, SLICE_BLOCKS + 1)), steps)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)

    if r1.chunk_count != SLICE_CHUNKS or len(r2.chunk_proofs) != SLICE_CHUNKS:
        raise AssertionError(f"expected {SLICE_CHUNKS} chunks, got {r1.chunk_count}")
    for c in r2.chunk_proofs:
        proof = json.loads(c.proof)["stark"]
        if proof["n"] != 4096 or not stark.verify_chunk(proof, prover.stark_params):
            raise AssertionError(f"chunk proof {c.chunk_id} does not verify")
    pub = [int(x) for x in json.loads(r4.final_proof.public_input)]
    if not groth16.verify(prover.verifying_key, json.loads(r4.final_proof.proof), pub):
        raise AssertionError("the final Groth16 proof does not verify")
    if len(base64.b64decode(r1.batch_data)) != 32 * SLICE_BLOCKS + 64:
        raise AssertionError("unexpected batch payload size")
    require_launches("batch proof", launches,
                     ("mont_mul", "mont_pow", "point_add", "point_add_masked", "point_add_g2",
                      "point_add_g2_masked", "poseidon2"))
    require_launches("batch proof, step 2", steps["gen_chunk_proof"], ("poseidon2",))
    require_at_most("batch proof", launches, "mont_mul", 200)
    if [name for name, _, _ in calls.times].count("msm_g2") != 1:
        raise AssertionError(f"expected one G2 MSM in the batch proof, got {calls.times}")

    log(f"[slice] {SLICE_BLOCKS} blocks, {r1.chunk_count} chunks of 4096 rows, mimc wrap")
    for step, s in times.items():
        log(f"[slice] {step}: {s:.3f} s")
    for name, n_points, s in calls.times:
        what = f"{name} of {n_points} points" if n_points else f"groth16.{name}, the whole call"
        log(f"[slice] gen_final_proof: {what}: {s:.3f} s")
    log(f"[slice] the G1 MSMs together: "
        f"{sum(s for name, _, s in calls.times if name == 'msm_g1'):.3f} s")
    log(f"[slice] total of the four steps: {sum(times.values()):.3f} s")
    log(f"[slice] max_memory_allocated: {peak / 2**20:.1f} MiB")
    log(f"[slice] launches: {launches}")
    log(f"[slice] {SLICE_CHUNKS}/{SLICE_CHUNKS} chunk proofs pass verify_chunk; the final "
        "proof passes groth16.verify")
    device_profile("slice step 2", lambda: prover.gen_chunk_proof(
        "smoke", r1.task_id, r1.chunk_count, CHAIN_ID, "evm", r1.batch_data))
    return launches


def phase_recursion(device) -> dict:
    """The batch proof as a node runs it: recursive aggregation on, the MiMC
    wrap, at the production chunk shape, through the four entry points; its
    2 chunks over a 2-way chunk axis (`BatchProver(mesh=)`, logical shards
    over the cards), step 2 held byte for byte to a serial step 2."""
    from eigen_zeth_tpu_torch.parallel import mesh

    chunk_mesh = mesh.make_mesh(n_domain=1, n_chunk=2, devices=mesh.logical_shards(2))
    prover = ps.BatchProver(recursion=True, wrap="mimc", device=device, mesh=chunk_mesh)
    sp = prover.stark_params
    shape = (prover.chunk_trace_rows, sp.blowup, sp.num_queries, sp.terminal_size,
             prover.agg_queries)
    if shape != (4096, 4, 32, 64, 30):
        raise AssertionError(f"not the production chunk shape: {shape}")

    # step 3 by stage: every stage of every attestation, synchronised
    stages, last = [], [0.0]

    def on_stage(name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages.append((name, now - last[0], torch.cuda.max_memory_allocated(device)))
        last[0] = now

    attest_chunk = recursion.attest_chunk

    def attest_from_now(*args, **kwargs):
        torch.cuda.synchronize()
        last[0] = time.perf_counter()  # the trace build starts here
        return attest_chunk(*args, **kwargs)

    steps = {}
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    air.STAGE_HOOK, recursion.attest_chunk = on_stage, attest_from_now
    try:
        with timed_funcs(STEP4_PARTS) as calls:
            r1, r2, r3, r4, times = drive(prover, list(range(1, RECURSION_BLOCKS + 1)), steps)
    finally:
        air.STAGE_HOOK, recursion.attest_chunk = None, attest_chunk
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)

    if r1.chunk_count != 2 or len(r2.chunk_proofs) != 2:
        raise AssertionError(f"expected 2 chunks, got {r1.chunk_count}")
    # step 2 again, serial and then over the mesh once more: the second
    # mesh call shows what the first call's warm-up cost
    again = {}
    for name, m in (("serial", None), ("mesh, after the serial", chunk_mesh)):
        prover.mesh = m
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = prover.gen_chunk_proof("smoke", r1.task_id, r1.chunk_count, CHAIN_ID, "evm",
                                   r1.batch_data)
        torch.cuda.synchronize()
        again[name] = time.perf_counter() - t
        if [c.proof for c in r.chunk_proofs] != [c.proof for c in r2.chunk_proofs]:
            raise AssertionError(f"step 2 ({name}) differs from step 2 over the chunk mesh")
    chunks = [json.loads(c.proof)["stark"] for c in r2.chunk_proofs]
    for i, proof in enumerate(chunks):
        if proof["n"] != 4096 or len(proof["fri"]["roots"]) != 8:
            raise AssertionError(f"chunk proof {i} has not the production shape")
        if not stark.verify_chunk(proof, sp):
            raise AssertionError(f"chunk proof {i} does not verify")
    agg = json.loads(r3.result_string)
    if [k["type"] for k in agg["children"]] != ["chunk-attested"] * 2:
        raise AssertionError("step 3 did not replace the chunk children by attestations")
    t = time.perf_counter()
    digests = []
    for i, att in enumerate(agg["children"]):
        p = att["air_proof"]
        if (p["n"], p["n_cols"], p["ext_blowup"], p["num_queries"]) != (1 << 18, ATT_COLS, 8, 30):
            raise AssertionError(f"attestation {i} has not the production shape")
        # raises ValueError where the verifier AIR's proof is rejected
        digest = recursion.verify_attestation(att, expected_queries=32, expected_rows=4096,
                                              expected_terminal=64)
        if digest != ps.chunk_digest(chunks[i]):
            raise AssertionError(f"attestation {i} does not bind its chunk's digest")
        digests.append(digest)
    t_verify = time.perf_counter() - t
    if [str(x) for x in poseidon.hash_two_host(*digests)] != agg["digest"]:
        raise AssertionError("the aggregated digest is not the hash of its children's")
    pub = [int(x) for x in json.loads(r4.final_proof.public_input)]
    if not groth16.verify(prover.verifying_key, json.loads(r4.final_proof.proof), pub):
        raise AssertionError("the final Groth16 proof does not verify")
    for step in ("gen_chunk_proof", "gen_aggregated_proof"):
        require_launches(f"recursion, {step}", steps[step], ("poseidon2",))
    per_attestation = steps["gen_aggregated_proof"]["poseidon2"] / len(agg["children"])
    if per_attestation > E_ATTESTATION_MOST:
        raise AssertionError(f"{per_attestation} launches of kernel E per attestation, "
                             f"expected at most {E_ATTESTATION_MOST}")
    require_rows_once("recursion", steps["gen_aggregated_proof"], len(agg["children"]))
    require_launches("recursion", launches,
                     ("mont_mul", "mont_pow", "point_add", "point_add_masked", "point_add_g2",
                      "point_add_g2_masked", "poseidon2"))

    log(f"[recursion] {RECURSION_BLOCKS} blocks, {r1.chunk_count} chunks of 4096 rows "
        f"(blowup {sp.blowup}, {sp.num_queries} queries, terminal {sp.terminal_size}), "
        f"{prover.agg_queries} queries of the attestation STARK, mimc wrap; step 2 over the "
        f"chunk mesh {[str(d) for d in chunk_mesh.chunk_devices()]}, byte-identical to a "
        f"serial step 2 ({again['serial']:.3f} s) and to the mesh's again after it "
        f"({again['mesh, after the serial']:.3f} s)")
    for step, s in times.items():
        log(f"[recursion] {step}: {s:.3f} s, poseidon2 launches {steps[step]['poseidon2']}, "
            f"poseidon2_rows {steps[step]['poseidon2_rows']}")
    log(f"[recursion] kernel E launches per attestation: {per_attestation:g}")
    k = 0
    for name, s, mem in stages:
        k += name == "trace"
        log(f"[recursion] gen_aggregated_proof, attestation {k}: {name}: {s:.3f} s "
            f"(peak so far {mem / 2**20:.0f} MiB)")
    for name, n_points, s in calls.times:
        what = f"{name} of {n_points} points" if n_points else f"groth16.{name}, the whole call"
        log(f"[recursion] gen_final_proof: {what}: {s:.3f} s")
    log(f"[recursion] total of the four steps: {sum(times.values()):.3f} s")
    log(f"[recursion] max_memory_allocated: {peak / 2**20:.1f} MiB")
    log(f"[recursion] launches: {launches}")
    log(f"[recursion] 2/2 chunk proofs pass verify_chunk; 2/2 attestations (2^18 rows x "
        f"{ATT_COLS} columns, LDE 2^21) pass verify_attestation under the pinned shape "
        f"({t_verify:.3f} s on the host); the aggregated digest is their hash; the final "
        "proof passes groth16.verify")
    return launches


class timed_funcs:
    """While active, every call of the given module functions is
    synchronised and its wall time kept as (name, length of the first
    argument if it is a list else 0, seconds), in call order."""

    def __init__(self, targets):
        self.targets = targets
        self.times = []

    def __enter__(self):
        self._saved = [getattr(mod, name) for mod, name in self.targets]
        for (mod, name), fn in zip(self.targets, self._saved):
            setattr(mod, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            size = len(args[0]) if args and isinstance(args[0], list) else 0
            self.times.append((name, size, time.perf_counter() - t))
            return out
        return run

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.targets, self._saved):
            setattr(mod, name, fn)
        return False

    def total(self, name: str) -> float:
        return sum(s for n, _, s in self.times if n == name)


STEPS = ("gen_batch_chunks", "gen_chunk_proof", "gen_aggregated_proof", "gen_final_proof")


class serve_steps:
    """While active, each of the server prover's four steps is synchronised
    and timed on the handler thread, and its launch counts and its result
    kept (the last call of each step)."""

    def __init__(self, prover):
        self.prover = prover
        self.times, self.launches, self.results = {}, {}, {}

    def __enter__(self):
        for step in STEPS:
            def run(*args, _fn=getattr(self.prover, step), _step=step):
                self.results[_step] = timed_step(_step, lambda: _fn(*args), self.times,
                                                 self.launches)
                return self.results[_step]
            setattr(self.prover, step, run)
        return self

    def __exit__(self, *exc):
        for step in STEPS:
            delattr(self.prover, step)
        return False


def log_wire(node, wire: list) -> None:
    """On the node's client: each request's step, id, serialized bytes of
    request and response, and the node's wall from sending to receiving."""
    request = node.client.request

    def logged(build):
        sent = []

        def fill(req):
            build(req)
            sent.append(req)

        t = time.perf_counter()
        resp = request(fill)
        wall = time.perf_counter() - t
        req = sent[-1]
        step = req.WhichOneof("request_type")
        if step == "gen_batch_proof":
            step = req.gen_batch_proof.WhichOneof("step")
        wire.append({"step": step, "id": req.id, "request_bytes": req.ByteSize(),
                     "response_bytes": resp.ByteSize(), "node_s": wall})
        return resp

    node.client.request = logged


def phase_stark_wrap(device, signed: list) -> dict:
    """The node's default, sound final wrap at the node's configuration,
    reached as a deployment reaches it: the port's node and the port's
    prover server in this process, over loopback.  The node
    (`cli.cmd_run` on `run --prover-addr ... --settlement mock --database
    memory --verify-signatures --dev-fund`) seals the signed transactions it
    was sent; the prover process's own code (`cli.cmd_prover` on `prover
    --final-wrap stark --device cuda --l2-addr <the node>`) serves
    ProverService over gRPC, with `ChainExecutor` reading the node:
    `BatchProver(recursion=True, wrap="stark")`, the production chunk shape
    and the default wrap profile (11 queries, 12 grinding bits, blowup 32,
    two leaves).  The CRS is made first on the server's prover, as a
    deployment does once (`ensure_wrap_crs`, into a fresh directory); then
    the transactions go in over eth_sendRawTransaction, the node's Sequencer
    seals them, and the node's operator drives the four steps over the wire
    and settles the proof."""
    from eigen_zeth_tpu_torch.models import crs, wrap_circuit
    from eigen_zeth_tpu_torch.native.zethdb import NativeDb
    from eigen_zeth_tpu_torch.protocol import kv
    from eigen_zeth_tpu_torch.protocol.grpc_gen.prover.v1 import prover_pb2 as pb
    from eigen_zeth_tpu_torch.protocol.grpc_shim import RemoteBatchProver
    from eigen_zeth_tpu_torch.sequencer import cl_driver
    from eigen_zeth_tpu_torch.settlement.bridge_mock import BridgeService
    from eigen_zeth_tpu_torch.settlement.custom import CustomSettlement
    from eigen_zeth_tpu_torch.utils.config import global_env

    bridge = BridgeService().start()
    os.environ["BRIDGE_SERVICE_ADDR"] = bridge.url
    global_env.cache_clear()  # the node reads BRIDGE_SERVICE_ADDR when it starts
    with scratch_dir() as crs_dir:
        db_path = str(Path(crs_dir) / "zeth.db")
        node, server = node_and_prover_server(crs_dir, [
            "--final-wrap", "stark", "--crs-dir", crs_dir, "--device", "cuda"],
            database="native", settlement="custom")
        addr = f"127.0.0.1:{server.port}"
        node_url = f"http://127.0.0.1:{node['server'].port}"
        client = RemoteBatchProver(addr)
        try:
            prover = server.prover
            sp = prover.stark_params
            shape = (prover.chunk_trace_rows, sp.blowup, sp.num_queries, sp.terminal_size,
                     prover.wrap_queries, prover.wrap_grind_bits, prover.wrap_blowup,
                     prover.max_wrap_leaves, prover.device.type)
            if shape != (4096, 4, 32, 64, 11, 12, 32, 2, "cuda"):
                raise AssertionError(f"not the node's configuration: {shape}")

            stages, last = [], [0.0]

            def on_stage(name: str) -> None:
                torch.cuda.synchronize()
                now = time.perf_counter()
                stages.append((name, now - last[0], torch.cuda.max_memory_allocated(device)))
                last[0] = now

            attest = recursion.attest_chunk_wrap

            def attest_from_now(*args, **kwargs):
                torch.cuda.synchronize()
                last[0] = time.perf_counter()  # the trace build starts here
                return attest(*args, **kwargs)

            sizes = []
            build = wrap_circuit.build_final_circuit

            def build_counted(*args, **kwargs):
                out = build(*args, **kwargs)
                sizes.append((len(out[0].constraints), out[0].num_vars))
                return out

            targets = ((stark, "prove_chunk"), (wrap_circuit, "build_final_circuit"),
                       (crs, "generate"), (groth16, "_lagrange_at"),
                       (groth16, "fixed_base_device"), (crs, "save"), (crs, "load"),
                       (groth16, "_row_values"), (groth16, "_h_from_values_device"),
                       (msm, "msm_affine"), (groth16, "prove"), (groth16, "verify"))
            torch.cuda.reset_peak_memory_stats(device)
            air.STAGE_HOOK, recursion.attest_chunk_wrap = on_stage, attest_from_now
            wrap_circuit.build_final_circuit = build_counted
            try:
                with timed_funcs(targets) as crs_calls:
                    kernels.reset_launches()
                    t = time.perf_counter()
                    prover.ensure_wrap_crs(AGGREGATOR)
                    torch.cuda.synchronize()
                    t_crs = time.perf_counter() - t
                    crs_launches = dict(kernels.LAUNCHES)
                crs_stages = list(stages)
                stages.clear()
                crs_peak = torch.cuda.max_memory_allocated(device)
                torch.cuda.reset_peak_memory_stats(device)
                prover._stark_crs.clear()  # step 4 loads the CRS from its files, as a node does
                vk = prover.pinned_vk(AGGREGATOR)
                bridge.vk = vk  # the L1 verifier's role: verify-batches under the pinned VK
                wire = []
                log_wire(node["operator"].prover, wire)
                engine = cl_driver.EngineClient(node_url, timeout=120.0)
                ticked = []

                def seal():
                    ticked.append(cl_driver.tick(engine, AGGREGATOR))
                    if ticked[-1] is None:
                        raise AssertionError("the CL driver's forkchoiceUpdated built no payload")
                    return ticked[-1]

                def settled():
                    done = bridge.state.verified
                    return done[-1]["new_state_root"] if done else None

                with timed_funcs(targets) as calls, serve_steps(prover) as served:
                    kernels.reset_launches()
                    # a failed step raises at once, with the server's message
                    sealed = seal_and_prove(node, signed, served.results, 900, poll_s=5.0,
                                            seal=seal, settled=settled)
                launches = dict(kernels.LAUNCHES)
                times, steps = served.times, served.launches
            finally:
                air.STAGE_HOOK, recursion.attest_chunk_wrap = None, attest
                wrap_circuit.build_final_circuit = build
            peak = torch.cuda.max_memory_allocated(device)
            status = client.get_status()
            r1, r2, r3, r4 = (served.results[step] for step in STEPS)

            # gates
            if [w["step"] for w in wire] != list(STEPS):
                raise AssertionError(f"the node sent {[w['step'] for w in wire]}")
            if (status.status != pb.GetStatusResponse.Status.STATUS_IDLE
                    or status.prover_status.last_computed_request_id != wire[-1]["id"]):
                raise AssertionError(f"GetStatus after the batch: {status}")
            parent, block = check_node_block(sealed, L2_TXS)
            if int(block["number"], 16) != L2_BLOCK:
                raise AssertionError(f"the node sealed block {block['number']}")
            result = sealed["proof"]
            if (result["proof"], result["publicInput"]) != (r4.final_proof.proof,
                                                            r4.final_proof.public_input):
                raise AssertionError("eigenrpc does not serve the server's final proof")
            payload = base64.b64decode(r1.batch_data)
            if payload[:64].hex() != parent["stateRoot"][2:] + block["stateRoot"][2:]:
                raise AssertionError("the proved payload does not open with the node's roots")
            if r1.chunk_count != 2 or len(r2.chunk_proofs) != 2:
                raise AssertionError(f"expected 2 chunks, got {r1.chunk_count}")
            chunks = [json.loads(c.proof)["stark"] for c in r2.chunk_proofs]
            for i, proof in enumerate(chunks):
                if proof["n"] != 4096 or not stark.verify_chunk(proof, sp):
                    raise AssertionError(f"chunk proof {i} does not verify")
            agg = json.loads(r3.result_string)
            if [k["type"] for k in agg["children"]] != ["chunk-attested-wrap"] * 2:
                raise AssertionError("step 3 did not make wrap-profile attestations")
            t = time.perf_counter()
            stmts = []
            for i, att in enumerate(agg["children"]):
                p = att["wrap_proof"]
                if (p["n"], p["n_cols"], p["ext_blowup"], p["num_queries"], p["grind_bits"]) != (
                        1 << 18, ATT_COLS, 32, 11, 12):
                    raise AssertionError(f"wrap attestation {i} has not the node's profile")
                digest = recursion.verify_attestation_wrap(
                    att, expected_queries=32, expected_rows=4096, expected_terminal=64,
                    expected_wrap_queries=11, expected_wrap_grind=12, wrap_blowup=32,
                    device=device)
                if digest != ps.chunk_digest(chunks[i]):
                    raise AssertionError(f"wrap attestation {i} does not bind its chunk's digest")
                a, publics, bnds = recursion.wrap_attestation_instance(
                    att, expected_queries=32, expected_rows=4096, expected_terminal=64,
                    wrap_blowup=32)
                stmts.append(wrap_circuit.statement_hash(a, publics, bnds, int(p["shift"]), 11,
                                                          12, device=device))
            t_verify = time.perf_counter() - t
            pub = [int(x) for x in json.loads(result["publicInput"])]
            if pub != [wrap_circuit.final_public_input(stmts, AGGREGATOR)]:
                raise AssertionError("the public input is not the statement hash of the chunks")
            proof = json.loads(result["proof"])
            t = time.perf_counter()
            if not groth16.verify(vk, proof, pub):
                raise AssertionError("the final proof does not verify under the pinned VK")
            t_pinned = time.perf_counter() - t
            forged = dict(proof, pi_c=dict(proof["pi_a"]))
            if groth16.verify(vk, forged, pub):
                raise AssertionError("a forged pi_c passes groth16.verify")
            # the bridge: verify-batches accepted under the pinned VK by its own
            # groth16.verify, the forged pi_c refused there too
            accepted = bridge.state.verified
            if bridge.vk is not vk or len(accepted) != 1 or (
                    accepted[0]["proof"], accepted[0]["input"]) != (result["proof"],
                                                                    result["publicInput"]):
                raise AssertionError(f"the bridge did not record the served proof: {accepted}")
            if len(bridge.state.sequenced) != 1:
                raise AssertionError("the bridge did not sequence the batch")
            try:
                CustomSettlement(bridge.url).verify_batches(
                    0, 1, 2, bytes(32), bytes.fromhex(block["stateRoot"][2:]), json.dumps(forged),
                    result["publicInput"])
            except RuntimeError as exc:
                if "proof rejected" not in str(exc):
                    raise
            else:
                raise AssertionError("the bridge accepted a forged pi_c")
            if len(bridge.state.verified) != 1:
                raise AssertionError("the bridge recorded a refused proof")
            if int(ticked[0]["number"], 16) != L2_BLOCK or ticked[0]["hash"] != block["hash"]:
                raise AssertionError("the CL driver's payload is not the node's block")
            bad = json.loads(r3.result_string)
            row = bad["children"][0]["wrap_proof"]["trace_openings"][0][0]["row"]
            row[0] = str((int(row[0]) + 1) % gl.P)
            res = client.gen_final_proof("smoke", json.dumps(bad), "BN128", AGGREGATOR)
            if res.result_code != ProofResultCode.COMPLETED_ERROR:
                raise AssertionError("a corrupted wrap attestation did not give COMPLETED_ERROR")
        finally:
            node["shutdown"]()
            if node["operator"]:
                node["operator"].prover.close()
            client.close()
            server.stop(0)
            bridge.stop()
            node["db"].close()
        # the node's native database after shutdown: reopened by the C++
        # engine, and its log read by the python one, with the batch's records
        records = []
        for engine_cls in (NativeDb, kv.FileDb):
            db = engine_cls(db_path)
            stored = db.get_proof(L2_BLOCK)
            records.append((stored and stored.proof, stored and stored.public_input,
                            db.get_status(L2_BLOCK), db.get_u64(kv.KEY_LAST_VERIFIED_BLOCK_NUMBER),
                            db.get(kv.KEY_PROVE_STEP_RECORD)))
            db.close()
        db_bytes = os.path.getsize(db_path)
    want = (result["proof"], result["publicInput"], kv.Status.Finalized, L2_BLOCK, None)
    if records != [want, want]:
        raise AssertionError(f"the native database does not hold the batch's records: {records}")
    for step in ("gen_chunk_proof",):
        require_launches(f"stark wrap, {step}", steps[step], ("poseidon2",))
    require_launches("stark wrap, gen_aggregated_proof", steps["gen_aggregated_proof"],
                     ("poseidon_fr",))
    require_rows_once("stark wrap", steps["gen_aggregated_proof"], len(agg["children"]))
    require_at_most("stark wrap, gen_aggregated_proof", steps["gen_aggregated_proof"],
                    "poseidon_fr", F_STEP3_MOST)
    require_launches("stark wrap, gen_final_proof", steps["gen_final_proof"],
                     ("mont_mul", "mont_pow", "point_add", "point_add_masked", "point_add_g2",
                      "point_add_g2_masked"))
    require_launches("stark wrap, ensure_wrap_crs", crs_launches, ("point_add", "point_add_g2"))

    # the device fixed-base against the host one on 2^14 scalars (G1) and 2^10 (G2)
    rng = np.random.default_rng(77)
    for g2, n in ((False, 1 << 14), (True, 1 << 10)):
        scalars = [int.from_bytes(rng.bytes(32), "little") % bn254.R for _ in range(n)]
        scalars[1] = 0
        if groth16.fixed_base_device(scalars, g2, device).to_host() != groth16._host_fixed_base(
                scalars, g2):
            raise AssertionError(f"the device fixed-base differs from the host's ({n} scalars)")

    log(f"[stark-wrap] the devnet in one process: the bridge service at {bridge.url} (its "
        f"verify-batches under the pinned VK), the port's node at {node_url} (run --settlement "
        f"custom --database native --prover-addr {addr}), the prover server at {addr} (gRPC), "
        f"ChainExecutor on the node, the CL driver's engine_forkchoiceUpdatedV3 / getPayloadV3 "
        f"/ newPayloadV3 sealing: block {L2_BLOCK}, "
        f"{len(block['transactions'])} signed legacy transactions, {int(block['gasUsed'], 16)} "
        f"gas, a payload of {len(payload)} bytes, {r1.chunk_count} chunks of 4096 rows (blowup "
        f"4, 32 queries, terminal 64); wrap profile 11 queries, 12 grinding bits, blowup 32, "
        f"{prover.max_wrap_leaves} leaves")
    log(f"[stark-wrap] node: eth_sendRawTransaction x {L2_TXS}: {sealed['send_s']:.3f} s; one "
        f"cl_driver.tick (the engine API: execute and seal the block): {sealed['seal_s']:.3f} "
        f"s; block sealed to proof served by eigenrpc_getBatchProof: {sealed['served_s']:.3f} "
        f"s (polled every 5 s); to settled (the bridge's verify-batches under the pinned VK, "
        f"Finalized): {sealed['settled_s']:.3f} s; the native database {db_bytes} bytes")
    log(f"[stark-wrap] ensure_wrap_crs: {t_crs:.3f} s, peak {crs_peak / 2**20:.0f} MiB, "
        f"launches {crs_launches}")
    for name, secs, mem in crs_stages:
        log(f"[stark-wrap] ensure_wrap_crs, padding attestation: {name}: {secs:.3f} s "
            f"(peak so far {mem / 2**20:.0f} MiB)")
    for name, _, secs in crs_calls.times:
        if name not in ("fixed_base_device",):
            log(f"[stark-wrap] ensure_wrap_crs: {name}: {secs:.3f} s")
    log(f"[stark-wrap] ensure_wrap_crs: fixed_base_device x "
        f"{sum(1 for n, _, _ in crs_calls.times if n == 'fixed_base_device')}: "
        f"{crs_calls.total('fixed_base_device'):.3f} s")
    log(f"[stark-wrap] circuit: {sizes[0][0]} constraints, {sizes[0][1]} variables")
    for w in wire[:len(STEPS)]:
        step = w["step"]
        log(f"[stark-wrap] {step}: server {times[step]:.3f} s, node {w['node_s']:.3f} s "
            f"(the gRPC hop {w['node_s'] - times[step]:.3f} s); request {w['request_bytes']} B, "
            f"response {w['response_bytes']} B; launches F {steps[step]['poseidon_fr']}, "
            f"E {steps[step]['poseidon2']}, B {steps[step]['point_add']}, "
            f"B G2 {steps[step]['point_add_g2']}, A {steps[step]['mont_mul']}")
    largest = max(max(w["request_bytes"], w["response_bytes"]) for w in wire)
    log(f"[stark-wrap] largest gRPC message: {largest} B ({largest / 2**20:.3f} MiB; gRPC's "
        f"default limit 4 MiB)")
    k = 0
    for name, secs, mem in stages:
        k += name == "trace"
        log(f"[stark-wrap] gen_aggregated_proof, attestation {k}: {name}: {secs:.3f} s "
            f"(peak so far {mem / 2**20:.0f} MiB)")
    msms = 0
    for name, _, secs in calls.times:
        msms += name == "msm_affine"
        if name != "prove_chunk":
            # groth16.prove's second MSM is B's, over b2_query: the G2 MSM
            label = f"{name} (the G2 MSM)" if name == "msm_affine" and msms == 2 else name
            log(f"[stark-wrap] gen_final_proof: {label}: {secs:.3f} s")
    log(f"[stark-wrap] total of the four steps: server {sum(times.values()):.3f} s, node "
        f"{sum(w['node_s'] for w in wire):.3f} s (the operator's RemoteBatchProver calls)")
    log(f"[stark-wrap] max_memory_allocated: {peak / 2**20:.1f} MiB (steps), "
        f"{crs_peak / 2**20:.1f} MiB (CRS)")
    log(f"[stark-wrap] launches: {launches}")
    log(f"[stark-wrap] {L2_TXS}/{L2_TXS} transactions mined with status 1 in the CL driver's "
        f"block; eigenrpc serves the server's final proof; the bridge accepted it under the "
        f"pinned VK and refused a forged pi_c; the native database, reopened by NativeDb and "
        f"read by FileDb, holds the batch's proof, Finalized and the verified watermark; "
        f"2/2 chunk proofs pass "
        f"verify_chunk; 2/2 wrap attestations pass verify_attestation_wrap under the pinned "
        f"profile ({t_verify:.3f} s); the payload opens with the node's state roots "
        f"(eth_getBlockByNumber) and the public input is the statement hash of the chunks; "
        f"groth16.verify under the "
        f"pinned VK is True ({t_pinned:.3f} s); a forged pi_c is rejected; a corrupted "
        f"attestation gives COMPLETED_ERROR over the wire; GetStatus after the batch: "
        f"STATUS_IDLE, last computed request {status.prover_status.last_computed_request_id}; "
        f"the device fixed-base equals the host's on 2^14 G1 and 2^10 G2 scalars")
    return launches


def phase_node_in_process(device, signed: list) -> dict:
    """The node's default topology: `run` proving in process on the card
    (`cli.cmd_run` on `run --device cuda --final-wrap mimc`, no
    --prover-addr: `BatchProver`'s defaults otherwise, recursion on at the
    production chunk shape).  The signed transactions go in over
    eth_sendRawTransaction, the node's Sequencer seals them into one block,
    and the operator's workers prove it in this process, settle it and
    serve it over eigenrpc."""
    with scratch_dir() as tmp:
        node = run_node(tmp, "--device", "cuda", "--final-wrap", "mimc")
        try:
            prover = node["operator"].prover
            sp = prover.stark_params
            shape = (type(prover).__name__, prover.device.type, prover.wrap, prover.recursion,
                     prover.chunk_trace_rows, sp.blowup, sp.num_queries, sp.terminal_size,
                     prover.agg_queries)
            if shape != ("BatchProver", "cuda", "mimc", True, 4096, 4, 32, 64, 30):
                raise AssertionError(f"not the node's in-process prover: {shape}")
            with serve_steps(prover) as steps:
                kernels.reset_launches()
                sealed = seal_and_prove(node, signed, steps.results, 300, poll_s=1.0)
            launches = dict(kernels.LAUNCHES)
            parent, block = check_node_block(sealed, NODE_TXS)
            r1 = steps.results["gen_batch_chunks"]
            pub = [int(x) for x in json.loads(sealed["proof"]["publicInput"])]
            t = time.perf_counter()
            if not groth16.verify(prover.verifying_key, json.loads(sealed["proof"]["proof"]),
                                  pub):
                raise AssertionError("the in-process node's proof does not verify")
            t_verify = time.perf_counter() - t
        finally:
            node["shutdown"]()
    for step in STEPS:
        if step != "gen_batch_chunks":
            require_launches(f"in-process node, {step}", steps.launches[step],
                             {"gen_chunk_proof": ("poseidon2",),
                              "gen_aggregated_proof": ("poseidon2", "poseidon2_rows"),
                              "gen_final_proof": ("mont_mul", "point_add")}[step])
    require_launches("in-process node", launches, ("mont_mul", "point_add", "poseidon2"))
    log(f"[node] run --device cuda --final-wrap mimc (in-process BatchProver, recursion on, "
        f"4096-row chunks): block {block['number']}, {len(block['transactions'])} signed "
        f"legacy transactions, {int(block['gasUsed'], 16)} gas, {r1.chunk_count} chunk(s)")
    log(f"[node] eth_sendRawTransaction x {NODE_TXS}: {sealed['send_s']:.3f} s; execute and "
        f"seal: {sealed['seal_s']:.3f} s; block sealed to proof served by "
        f"eigenrpc_getBatchProof: {sealed['served_s']:.3f} s (polled every 1 s); to settled: "
        f"{sealed['settled_s']:.3f} s")
    for step in STEPS:
        log(f"[node] {step}: {steps.times[step]:.3f} s; launches E "
            f"{steps.launches[step]['poseidon2']}, B {steps.launches[step]['point_add']}, "
            f"A {steps.launches[step]['mont_mul']}")
    log(f"[node] launches: {launches}")
    log(f"[node] {NODE_TXS}/{NODE_TXS} transactions mined with status 1; the proof served by "
        f"eigenrpc binds the node's state roots {parent['stateRoot'][:10]}.. -> "
        f"{block['stateRoot'][:10]}.., the mock settlement recorded it, and it passes "
        f"groth16.verify under the prover's key ({t_verify:.3f} s)")
    return launches


def _host_eval(coeffs, z: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % bn254.R
    return acc


def test_points(device):
    """2^18 distinct G1 points on the card with their discrete logs."""
    t = time.perf_counter()
    xs, ys, dlogs = msm.gen_test_points(MSM_LOG2, device=device)
    torch.cuda.synchronize()
    log(f"[msm] gen_test_points({MSM_LOG2}) (host scalar multiplications + one device combine): "
        f"{time.perf_counter() - t:.3f} s")
    return xs, ys, dlogs


def phase_msm(device, points) -> dict:
    """The fast G1 MSM at 2^18 points through `msm.msm_g1_device`."""
    n = 1 << MSM_LOG2
    rng = np.random.default_rng(18)
    xs, ys, dlogs = points
    scalars = [int.from_bytes(rng.bytes(32), "little") % bn254.R for _ in range(n)]
    t = time.perf_counter()
    want = bn254.h_ec_mul_jac_f(sum(s * k for s, k in zip(scalars, dlogs)) % bn254.R, bn254.G1_GEN)
    t_oracle = time.perf_counter() - t
    inf = torch.zeros(n, dtype=torch.bool, device=device)
    limbs = msm._limbs_tensor(scalars, device)

    # the inner function shows `bad`; its first call also warms the card up
    windows = lambda: msm._msm_g1_fast_windows(  # noqa: E731
        xs, ys, inf, limbs, MSM_C, MSM_SERIAL, MSM_GROUP)
    *_, bad = windows()
    if bool(bad):
        raise AssertionError("the fast MSM raised `bad` on distinct points")
    torch.cuda.synchronize()
    t = time.perf_counter()
    windows()
    torch.cuda.synchronize()
    t_device = time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t = time.perf_counter()
    got = msm.msm_g1_device(xs, ys, inf, scalars, c=MSM_C, serial=MSM_SERIAL,
                            window_group=MSM_GROUP)
    torch.cuda.synchronize()
    t_entry = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)
    if got != want:
        raise AssertionError("the 2^18 MSM differs from the host oracle")
    if launches["point_scan_step"] != MSM_SERIAL:
        raise AssertionError(f"kernel C launched {launches['point_scan_step']} times, "
                             f"expected {MSM_SERIAL}")
    require_launches("fast MSM", launches,
                     ("mont_mul", "mont_pow", "point_add", "point_add_masked", "point_scan_step"))
    require_at_most("fast MSM", launches, "mont_mul", 16)

    log(f"[msm] 2^{MSM_LOG2} points, c = {MSM_C}, serial {MSM_SERIAL}, window group {MSM_GROUP}: "
        "bad = False, result equals the host oracle")
    log(f"[msm] host oracle (one scalar multiplication of G by Σ s_i·k_i): {t_oracle:.3f} s")
    log(f"[msm] device part alone (digits to affine window sums, synchronised): "
        f"{t_device:.4f} s = {n / t_device:.0f} points/s")
    log(f"[msm] msm_g1_device end to end (host scalar limbs and Horner included): "
        f"{t_entry:.4f} s = {n / t_entry:.0f} points/s")
    log(f"[msm] max_memory_allocated: {peak / 2**20:.1f} MiB")
    log(f"[msm] launches: {launches}")
    device_profile("msm", windows)

    # a duplicated point under one scalar: `bad` rises, the result stands
    m = 64
    small = msm.host_points(bn254.FqOps(), xs[:, :m], ys[:, :m], inf[:m])
    small[9] = small[8]
    sc = scalars[:m]
    sc[9] = sc[8]
    sx, sy, sinf = (t[..., :m].contiguous().clone() for t in (xs, ys, inf))
    sx[:, 9], sy[:, 9] = sx[:, 8], sy[:, 8]
    *_, bad = msm._msm_g1_fast_windows(sx, sy, sinf, msm._limbs_tensor(sc, device), 8, 32, 32)
    if not bool(bad):
        raise AssertionError("a duplicated point did not raise `bad`")
    oracle = None
    for pt, k in zip(small, sc):
        oracle = bn254.h_ec_add(oracle, bn254.h_ec_mul_jac_f(k, pt))
    if msm.msm_g1_device(sx, sy, sinf, sc, c=8) != oracle:
        raise AssertionError("the collision fallback differs from the host oracle")
    log(f"[msm] {m} points with one duplicated: bad = True, the complete-add schedule "
        "recomputes, result equals the host's")
    return launches


def phase_kzg(device) -> dict:
    """KZG at one blob's size: SRS on the card, commit, open, verify."""
    rng = np.random.default_rng(4844)
    draw = lambda k: [int.from_bytes(rng.bytes(32), "little") % bn254.R for _ in range(k)]  # noqa: E731
    tau, z = draw(2)
    coeffs = draw(KZG_SIZE)
    total = {name: 0 for name in kernels.LAUNCHES}
    steps = {}

    def run(step, fn):
        kernels.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[step] = (time.perf_counter() - t, dict(kernels.LAUNCHES))
        for name, k in steps[step][1].items():
            total[name] += k
        return out

    torch.cuda.reset_peak_memory_stats(device)
    srs = run("setup_insecure", lambda: kzg.setup_insecure(KZG_SIZE, tau, device))
    commitment = run("commit", lambda: kzg.commit(srs, coeffs))
    proof, y = run("open_at", lambda: kzg.open_at(srs, coeffs, z))
    peak = torch.cuda.max_memory_allocated(device)
    t = time.perf_counter()
    ok = kzg.verify(srs, commitment, z, y, proof)
    rejected = not kzg.verify(srs, commitment, z, (y + 1) % bn254.R, proof)
    t_verify = time.perf_counter() - t

    host = srs.g1_points_host()
    for i in (0, 1, 2, KZG_SIZE - 1):
        if host[i] != bn254.h_ec_mul_jac_f(pow(tau, i, bn254.R), bn254.G1_GEN):
            raise AssertionError(f"SRS point {i} is not [tau^{i}]G1")
    if y != _host_eval(coeffs, z):
        raise AssertionError("open_at's value differs from the host evaluation")
    if not ok or not rejected:
        raise AssertionError(f"verify: right value {ok}, wrong value rejected {rejected}")
    on_path = ("mont_mul", "mont_pow", "point_add", "point_add_masked", "point_scan_step")
    require_launches("KZG commit", steps["commit"][1], on_path)
    require_launches("KZG open", steps["open_at"][1], on_path)
    require_launches("KZG setup", steps["setup_insecure"][1], ("mont_mul", "mont_pow"))

    log(f"[kzg] {KZG_SIZE}-point SRS on the card, {KZG_SIZE} coefficients: verify True, "
        "a wrong value rejected, p(z) equals the host evaluation")
    for step, (secs, launched) in steps.items():
        log(f"[kzg] {step}: {secs:.3f} s, launches {launched}")
    log(f"[kzg] verify twice (host pairing): {t_verify:.3f} s")
    log(f"[kzg] max_memory_allocated: {peak / 2**20:.1f} MiB")
    device_profile("kzg commit", lambda: kzg.commit(srs, coeffs))
    device_profile("kzg setup_insecure", lambda: kzg.setup_insecure(KZG_SIZE, tau, device))
    return total


def phase_madd(device, points) -> dict:
    """`bn254.point_madd_unsafe` (kernel D) on 2^17 pairs of distinct points,
    against the complete add (kernel B) and the host."""
    F = bn254.FqOps()
    xs, ys, _ = points
    half = xs.shape[1] // 2
    ax, ay, bx, by = (t.contiguous() for t in (xs[:, :half], ys[:, :half], xs[:, half:], ys[:, half:]))
    p = bn254.from_affine(F, ax, ay)
    kernels.reset_launches()
    t = time.perf_counter()
    out, bad = bn254.point_madd_unsafe(F, p, bx, by)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    require_launches("mixed add", launches, ("point_madd",))
    if bool(bad.any()):
        raise AssertionError("the mixed add raised `bad` on distinct points")
    full = msm.ECGroup(F).add(p, bn254.from_affine(F, bx, by))
    got, ref = bn254.to_affine(F, out), bn254.to_affine(F, full)
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError("the mixed add differs from the complete add")
    k = 4
    pts = msm.host_points(F, xs[:, [0, 1, 2, 3, half, half + 1, half + 2, half + 3]],
                          ys[:, [0, 1, 2, 3, half, half + 1, half + 2, half + 3]],
                          torch.zeros(2 * k, dtype=torch.bool))
    have = list(zip(map(int, F.to_int(got[0][:, :k])), map(int, F.to_int(got[1][:, :k]))))
    if have != [bn254.h_ec_add(pts[i], pts[k + i]) for i in range(k)]:
        raise AssertionError("the mixed add differs from the host's add")
    log(f"[madd] {half} mixed adds through bn254.point_madd_unsafe: bad = False, equal to the "
        f"complete add and to the host; {secs * 1e3:.3f} ms, launches {launches}")
    return launches


MULTI_NTT_LOG2 = 20  # the sharded NTT's size
MULTI_SHARDS = 4  # at least this many logical shards, laid over the cards
MULTI_MOST_S = 15.0  # the phase's budget


def phase_multidevice(device, points) -> dict:
    """The multi-device layer on a (chunk, domain) mesh over every card, with
    at least MULTI_SHARDS logical shards: `dryrun_multichip` at the path's
    sizes (the domain-sharded NTT and its inverse at 2^20 Goldilocks
    elements against the one-device `ntt`, `msm_dist_g1` on phase_msm's 2^18
    points against the one-device `msm` and the host), and `entry()`'s
    chunk-commit root against the same step on the CPU, under one
    `profile_trace` whose trace must hold kernel E."""
    from eigen_zeth_tpu_torch.parallel import dryrun, mesh
    from eigen_zeth_tpu_torch.utils.profiling import profile_trace

    t0 = time.perf_counter()
    cards = mesh.default_devices()
    shards = mesh.logical_shards(max(MULTI_SHARDS, len(cards)), cards)
    names = sorted({torch.cuda.get_device_name(d) for d in cards})
    log(f"[multi] {len(cards)} card(s) ({', '.join(names)}), {len(shards)} logical shards: "
        f"{[str(d) for d in shards]}")
    kernels.reset_launches()
    t = time.perf_counter()
    dry = dryrun.dryrun_multichip(len(shards), devices=cards, ntt_log2=MULTI_NTT_LOG2,
                                  g1=points, scalar_bits=254)
    times = {"dryrun_multichip": time.perf_counter() - t, **dry["times"]}

    fn, (coeffs,) = dryrun.entry(device)
    with scratch_dir() as tmp:
        t = time.perf_counter()
        with profile_trace(tmp) as path:
            root = fn(coeffs)
        times["entry under profile_trace"] = time.perf_counter() - t
        trace = Path(path).read_text()
    if not torch.equal(root.cpu(), fn(coeffs.cpu())):
        raise AssertionError("entry()'s root on the card differs from the CPU's")
    e_names = [k for k in ("hash_rows_kernel", "merkle_levels_kernel") if k in trace]
    if not e_names:
        raise AssertionError("the profile_trace around entry() holds no kernel E")
    launches = dict(kernels.LAUNCHES)
    require_launches("multi-device", launches, ("point_add", "point_add_masked", "poseidon2"))
    total = time.perf_counter() - t0
    for what, secs in times.items():
        log(f"[multi] {what}: {secs:.3f} s")
    n_chunk, n_domain = dry["mesh"]
    log(f"[multi] dryrun_multichip({len(shards)}): mesh {dry['mesh']} (chunk x domain); "
        f"ntt_sharded / intt_sharded of {dry['n']} over {n_domain} shards at each of "
        f"{n_chunk} chunk positions bit-exact to ntt and the input, IntGroup MSM equal to "
        f"numpy, msm_dist_g1 on {dry['ec_points']} points over {n_domain} shards equal to the "
        f"one-device msm and the host; entry()'s root equal to the CPU's, its trace "
        f"({len(trace)} bytes) holds kernel E ({', '.join(e_names)}); launches {launches}; "
        f"{total:.3f} s in all")
    if total > MULTI_MOST_S:
        raise AssertionError(f"the multi-device phase took {total:.1f} s, over its "
                             f"{MULTI_MOST_S} s budget")
    return launches


def phase(fn, *args):
    """fn(*args), its wall on the host clock logged."""
    t = time.perf_counter()
    out = fn(*args)
    log(f"[smoke] {fn.__name__}: {time.perf_counter() - t:.1f} s")
    return out


def main() -> int:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — this run needs a GPU")
    phase_environment()
    device = torch.device("cuda")
    phase(phase_build, device)
    t = time.perf_counter()
    signed = {name: [sign_raw(job) for job in l2_transactions(seed, n)]
              for name, seed, n in (("stark-wrap", L2_SEED, L2_TXS), ("node", NODE_SEED, NODE_TXS))}
    log(f"[smoke] {L2_TXS + NODE_TXS} transactions signed in {time.perf_counter() - t:.1f} s")
    timing = phase(phase_kernels, device)
    phase(phase_golden, device)
    paths = [phase(phase_slice, device)]
    points = test_points(device)
    paths += [phase(phase_msm, device, points), phase(phase_kzg, device),
              phase(phase_madd, device, points), phase(phase_multidevice, device, points),
              phase(phase_keccak, device)]
    del points
    paths += [phase(phase_recursion, device),
              phase(phase_stark_wrap, device, signed["stark-wrap"]),
              phase(phase_node_in_process, device, signed["node"])]
    names = [*KERNEL_WORK, "poseidon2", "poseidon2_rows", "poseidon_fr", "keccak256"]
    launches = {name: sum(path[name] for path in paths) for name in names}
    require_launches("main", launches, names)
    rows = [
        {"name": name, **kernels.KERNELS[name],
         "launches": launches[name], **timing[name]}
        for name in names
    ]
    log(f"[smoke] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
