"""The command without a card: it exits with another code than 0 and prints
no result."""

import subprocess
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        return  # the look for a card passes here; the chip's runs cover the rest
    p = subprocess.run([sys.executable, "orloj_bench/run.py", "--workload",
                        "glm4_9b.bimodal.r80", "--seed", "5", "--seconds", "1", "--trace", "0"],
                       cwd=CHECKOUT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
