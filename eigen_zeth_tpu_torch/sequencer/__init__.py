"""Sequencer / execution layer — the reference's custom-reth analog: a
mempool, the bridge-tx filter, the EVM and the block builder.  Host copies
of eigen_zeth_tpu/sequencer/ (the CL driver is not ported yet)."""
