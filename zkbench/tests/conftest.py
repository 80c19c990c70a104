"""The benchmark's own tests (run from the checkout's root:
`python -m pytest zkbench/tests -q`; the card's with `-m gpu`)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

# several test processes share the machine's cores: one thread each
torch.set_num_threads(1)
