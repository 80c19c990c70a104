"""eigen_zeth_tpu_torch — the PyTorch/CUDA port of eigen_zeth_tpu.

The JAX package `eigen_zeth_tpu` stays the reference.  This package keeps
its layout and its module and function names, so each counterpart is easy
to find, and it imports `torch`, never `jax`.

Layout:
  ops/        Goldilocks and BN254 field arithmetic, NTT (radix-2, four-step),
              Poseidon2 over Goldilocks and over BN254 Fr, MSM, pairing,
              Keccak; `ops/kernels.py` builds and launches the CUDA kernels
  csrc/       the CUDA C++ sources of those kernels (built with nvcc at
              first use into `_build/`)
  models/     Merkle, FRI, the chunk STARK (batched, over a mesh's chunk
              axis), the AIR prover and the recursive verifier AIR, the
              wrap-profile STARK and its in-circuit verifier (R1CS builder,
              wrap circuit), Groth16 and its CRS files, KZG
  protocol/   the batch prover service (`BatchProver`, `ChainExecutor`), the
              gRPC ProverService server and client (`grpc_shim.py`), the
              resumable proving state machine and its KV store, the
              eigenrpc JSON-RPC server (`rpc.py`), the reference's vectors
  native/     the zethdb KV engine (C++, built with g++ at first use)
  parallel/   chunk proving pipelined with host aggregation; the device
              mesh, the domain-sharded NTT, the distributed MSM and the
              driver's entry points (`dryrun.py`), one controller
  sequencer/  the L2: mempool, tx filter, block builder, the EVM, the CL
              driver over the engine API
  settlement/ the L1 verifier's proof encoding, the mock, Ethereum and
              custom (bridge-service) settlements, the bridge service, the
              proof / verify / rollup workers
  utils/      the environment config, RLP, secp256k1 and transactions, the
              Merkle-Patricia trie, headers, receipts, telemetry and traces
  operator.py the node's workers over a prover
  cli.py      `python -m eigen_zeth_tpu_torch run` (the node) and `prover`
              (the prover process), `init`

The node's layers (sequencer, settlement, eigenrpc, operator) are host
Python copies of the JAX package's and do no device work; the node proves
through the in-process `BatchProver` or a remote prover.

The device is always explicit: functions that create tensors take a
`device`, and `BatchProver(..., device=torch.device("cuda"))` proves on the
card.  On a CPU tensor every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
