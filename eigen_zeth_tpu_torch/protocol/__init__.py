"""The batch prover service."""
