"""Proof systems: Merkle, FRI, the chunk STARK, Groth16."""
