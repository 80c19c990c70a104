"""Field arithmetic, NTT, hashing, MSM and the CUDA kernel wrappers."""
