"""A configuration, a traffic mix, a cell and a metric added as new files and
new entries only, in a copy of the benchmark: the harness runs the new cell and
reads the new metric, and no file that was there changes."""
import hashlib
import json
import pathlib
import shutil

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file() and "__pycache__" not in str(p)}


def test_a_cell_mix_config_and_metric_from_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    (root / "portbench").mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "portbench", root / "portbench", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    bench = root / "portbench"

    config = json.loads((bench / "configs/mbpo_humanoid.json").read_text())
    config["name"] = "mbpo_humanoid_wide"
    config["overrides"]["sac_hidden_size"] = 256
    (bench / "configs/mbpo_humanoid_wide.json").write_text(json.dumps(config))
    shutil.copy(bench / "configs/mbpo_humanoid.py", bench / "configs/mbpo_humanoid_wide.py")
    (bench / "traffic/rollout_l3.json").write_text(json.dumps(
        {"driver": "imagined_rollout", "start_states": 100_000, "horizon": 3,
         "checked_rollouts": 2}))
    (bench / "metrics/rollouts_per_s.py").write_text(
        "def read(run):\n    return run.rollouts / run.window_s\n")
    (bench / "limits/hum_wide.l3.json").write_text(
        (bench / "limits/mbpo_hum.rollout.json").read_text())
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "mbpo_humanoid_wide", "source": config["source"],
                                "file": "portbench/configs/mbpo_humanoid_wide.json",
                                "reduced": [], "why": "a test's own configuration"})
    manifest["workloads"].append({"name": "hum_wide.l3", "config": "mbpo_humanoid_wide",
                                  "traffic": "rollout_l3", "chips": 1, "why": "a test's cell"})
    manifest["end_to_end"].append({"name": "rollouts_per_s", "unit": "1/s", "better": "higher",
                                   "bound": 0.05, "source": "host_clock",
                                   "workloads": ["hum_wide.l3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    result = harness.run_cell(root, "hum_wide.l3", 2**31 + 3, 0.2, False, device="cpu",
                              scale={"start_states": 200, "capacity": 20_000, "real_rows": 1_000})
    assert result["correct"] is True
    assert set(result["metrics"]) == {"rollouts_per_s", "setup_s"}
    assert result["metrics"]["rollouts_per_s"]["value"] > 0
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())
