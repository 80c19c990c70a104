"""Settlement layer: the L1 verifier's proof encoding, the Settlement
implementations (Ethereum, custom over the bridge service, mock), the
bridge service itself (`bridge_mock.py`) and the node's proof / verify /
rollup workers — host copies of eigen_zeth_tpu/settlement/."""
