"""On the card: each cell runs end to end through `zkbench/run.py` with a
short window and comes out correct.  Skipped without a CUDA device."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["chunks.stark-wrap-2leaf.block-30m",
                                      "aggregate.recursion-mimc.pair"])
def test_cell_runs_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run only on the card")
    p = subprocess.run([sys.executable, "zkbench/run.py", "--workload", workload,
                        "--seed", str((1 << 31) + 3), "--seconds", "2", "--trace", "0"],
                       cwd=CHECKOUT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


def test_no_result_without_a_card(tmp_path):
    """Without a CUDA device the command exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "zkbench/run.py", "--workload",
                        "chunks.stark-wrap-2leaf.block-30m", "--seed", "1", "--seconds", "1"],
                       cwd=CHECKOUT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
