"""The plain reference of the benchmark: the chunk STARK and the chunk
attestation in plain PyTorch on int64 tensors (no hand-written kernel),
with the service steps that the cells drive (`service`).  It imports
nothing of the program under test."""
