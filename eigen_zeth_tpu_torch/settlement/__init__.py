"""Settlement layer: the L1 verifier's proof encoding, the Settlement
implementations (Ethereum, mock) and the node's proof / verify / rollup
workers — host copies of eigen_zeth_tpu/settlement/."""
