"""BENCHMARK.json against the benchmark's contract, and every file it names."""
import json
import math
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_keys_and_limits():
    assert list(M) == ["command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"]
    assert M["paths"] == ["portbench"] and M["command"][1] == "portbench/run.py"
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_just_their_keys_and_names_are_allowed():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in M[group]]
        assert len(names) == len(set(names)), group
        for e in M[group]:
            assert set(e) - {"workloads"} == want if group in ("end_to_end", "per_layer") \
                else set(e) == want, e
            assert NAME.match(e["name"]), e["name"]
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
    for e in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    metric_names = [e["name"] for e in M["end_to_end"] + M["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_configs_are_used_and_their_files_lie_under_paths():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert (ROOT / c["file"]).with_suffix(".py").exists()
        assert c["source"].startswith("https://")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_has_its_files_and_metrics(cell):
    (w,) = [w for w in M["workloads"] if w["name"] == cell]
    assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
    assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    assert (BENCH / "limits" / f"{cell}.json").exists()
    e2e = [m["name"] for m in M["end_to_end"] if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in M["per_layer"] if cell in m.get("workloads", [cell])]
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], "moves a metric the cell does not report")


def test_every_metric_has_a_reader_and_shares_name_units():
    for m in M["end_to_end"] + M["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    (setup,) = [m for m in M["end_to_end"] if m["name"] == "setup_s"]
    assert setup["bound"] == 0.25 and "workloads" not in setup
    four = [w for w in M["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, math.floor(0.25 * len(M["workloads"])))


def test_layers_are_few_words_on_one_line():
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 0 < len(m["layer"].split()) <= 4
