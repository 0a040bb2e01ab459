"""On the card (skipped without one, decided inside each test): each
cell's control, the reference in float8 e4m3 put in the port's place, read
at the cell's own size on three seeds, fails the cell's limit, and the
port's own readings on the same seeds pass it. Run from the root of the
repository:

    python3 -m pytest hrmbench/tests/test_hrmbench_card.py -m card
"""
import json
import subprocess
import sys

import pytest
import torch

from hrmbench import harness

# cell -> (the check, the control's reading of it, seconds)
CELLS = {"deepseek-moe-16b.chat": ("served_gap_mean", "mean", 10),
         "granite-moe-3b-a800m.campaign": ("logit_error_row_median_max",
                                           "row_median_max", 8)}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_the_limit_the_port_meets(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    name, stat, seconds = CELLS[cell]
    out = subprocess.run(
        [sys.executable, "-m", "hrmbench.calibrate", "--workload", cell,
         "--seeds", "2147483659,2147483693,2147483743", "--seconds",
         str(seconds)], cwd=harness.ROOT, capture_output=True, text=True,
        check=True)
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    assert len(rows) == 3
    for r in rows:
        value, limit = next((v, lim) for n, v, lim, _ in r["checks"]
                            if n == name)
        assert value <= limit < r["control"][stat]
