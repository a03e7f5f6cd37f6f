"""On the card: each cell once at its full size, and its control (the
reference in the program's place, in TF32 products) at its full size on three
seeds, which the limits must call not correct."""
import json
import math
import pathlib
import subprocess
import sys

import pytest

from portbench import harness, readings

ROOT = pathlib.Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in harness.load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_correct_at_its_full_size(card, cell):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          str(2**31 + 77), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_at_full_size_is_not_correct(card, cell):
    limits = harness.load_json(ROOT / "portbench" / "limits" / f"{cell}.json")["limits"]
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        got = readings.read(cell, seed, "control", rollouts=3, device=card)
        assert any(not (math.isfinite(r[k]) and r[k] <= v) for r in got
                   for k, v in limits.items()), (seed, got)
