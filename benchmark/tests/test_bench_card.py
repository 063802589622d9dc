"""The correctness check's control on the card, at the cell's own size:
the program as configured reads correct on each seed, and the reference
computed in fp8 in the program's place does not.

    python -m pytest benchmark/tests -m card
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.card
def test_program_passes_and_fp8_control_fails_at_full_size(card):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmark", "tests",
                                      "calibrate.py"),
         "--workload", "zipvoice.longform", "--seconds", "4",
         "--seeds", "3300000001,3300000002,3300000003",
         "--control-seeds", "3300000011,3300000012,3300000013"],
        capture_output=True, text=True, timeout=1800, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    runs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    assert len(runs) == 6
    for r in runs:
        assert r["correct"] is (r["control"] is None), r
