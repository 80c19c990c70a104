"""eigen_zeth_tpu_torch — the PyTorch/CUDA port of eigen_zeth_tpu.

The JAX package `eigen_zeth_tpu` stays the reference.  This package keeps
its layout and its module and function names, so each counterpart is easy
to find, and it imports `torch`, never `jax`.

Layout:
  ops/        Goldilocks and BN254 field arithmetic, NTT, Poseidon2, MSM,
              pairing; `ops/kernels.py` builds and launches the CUDA kernels
  csrc/       the CUDA C++ sources of those kernels (built with nvcc at
              first use into `_build/`)
  models/     Merkle, FRI, the chunk STARK (batched), Groth16, KZG
  protocol/   the batch prover service (`BatchProver`)

The device is always explicit: functions that create tensors take a
`device`, and `BatchProver(..., device=torch.device("cuda"))` proves on the
card.  On a CPU tensor every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
