"""Settlement: the L2 JSON-RPC client the chain executor reads blocks through."""
