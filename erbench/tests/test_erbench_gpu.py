"""On the card: one run of the PairRange batch cell, 10 s, is correct.
Run with ``python -m pytest -m gpu erbench/tests`` on a machine with an
NVIDIA card; it skips elsewhere."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
def test_batch_pair_range_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run(
        [sys.executable, "erbench/run.py", "--workload",
         "ds1_products.batch_pair_range", "--seed", "4242424242",
         "--seconds", "10", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["metrics"]["batch_entities_per_s"]["value"] > 0
