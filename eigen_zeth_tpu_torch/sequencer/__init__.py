"""Sequencer / execution layer — the reference's custom-reth analog: a
mempool, the bridge-tx filter, the EVM, the block builder and the CL
driver (`cl_driver.py`, the slot ticker over the engine API).  Host copies
of eigen_zeth_tpu/sequencer/."""
