"""Protocol-wide derived constants (nothing-up-my-sleeve tags).

Copy of eigen_zeth_tpu/models/poseidon_tags.py."""

from __future__ import annotations

import functools

from ..ops.poseidon import _sha_to_field


@functools.lru_cache(maxsize=1)
def chunk_gamma() -> int:
    """Rolling-hash multiplier for the chunk AIR (models/stark.py)."""
    return _sha_to_field("ezt-chunk-air/gamma")
