"""One run of one cell, driven by data: ``BENCHMARK.json`` names the cell's
configuration and traffic; the configuration is ``configs/<name>.json`` with
its plain termination predicate beside it (``configs/<name>.py``); the
traffic is ``traffic/<mix>.json``, read by the general generator that it names
(``drivers/<driver>.py``); each metric is read by ``metrics/<metric>.py``;
the limits of the comparison are ``limits/<cell>.json``; the functions that a
traced run wraps in spans are listed in ``spans/*.json``. A later cell, mix,
configuration or metric is new files and new entries, and no edit.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import pathlib
import sys
import time
from typing import Dict, List, Optional

import torch

from portbench import tracing

FOREIGN = ("jax", "jaxlib", "flax", "mbrl_tpu")


def load_json(path: pathlib.Path):
    return json.loads(pathlib.Path(path).read_text())


def load_module(path: pathlib.Path):
    """A module of the benchmark's own files, loaded by its path (metric
    readers are named after metrics, which hold dots)."""
    name = "portbench_file_" + "".join(c if c.isalnum() else "_" for c in str(path))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def workload(manifest: Dict, name: str) -> Dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(manifest: Dict, name: str, traced: bool) -> List[Dict]:
    """The cell's end-to-end metrics, or with a trace its per-layer ones."""
    group = manifest["per_layer" if traced else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def load_cell(root: pathlib.Path, name: str):
    """A cell's manifest entry, configuration, termination predicate, traffic
    and generator, found by the names in ``BENCHMARK.json``."""
    root = pathlib.Path(root)
    bench = root / "portbench"
    manifest = load_json(root / "BENCHMARK.json")
    wl = workload(manifest, name)
    (entry,) = [c for c in manifest["configs"] if c["name"] == wl["config"]]
    config_path = root / entry["file"]
    terminated = load_module(config_path.with_suffix(".py")).terminated
    traffic = load_json(bench / "traffic" / f"{wl['traffic']}.json")
    driver = load_module(bench / "drivers" / f"{traffic['driver']}.py")
    return manifest, wl, load_json(config_path), terminated, traffic, driver


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: object
    setup_s: float
    window_s: float
    rollouts: int
    rows: int
    trace: Optional[tracing.Trace]


def foreign_modules() -> List[str]:
    """Top-level modules of JAX or of the JAX package that this process holds."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


def run_cell(root: pathlib.Path, name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             scale: Optional[Dict] = None, mode: str = "program") -> Dict:
    """One run: set-up and one warm rollout, the measured window, then the
    comparison. Returns the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest, wl, config, terminated, traffic, driver = load_cell(root, name)
    bench = pathlib.Path(root) / "portbench"
    limits = load_json(bench / "limits" / f"{name}.json")["limits"]
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    spans = tracing.Spans(bench) if traced else None
    if spans:
        spans.install()
    try:
        t_cell = time.perf_counter()
        cell = driver.Cell(config, traffic, seed, device, terminated, scale=scale, mode=mode)
        sync()
        t_warm = time.perf_counter()
        cell.rollout()  # warm: every shape of the window, and the kernels' build
        sync()
        setup_s = time.perf_counter() - t_start
        print(f"portbench set-up: {t_cell - t_start:.3f} s to the cell, inputs and program "
              f"{t_warm - t_cell:.3f} s, warm rollout {t_start + setup_s - t_warm:.3f} s",
              file=sys.stderr)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        prof = tracing.profiler() if traced else None
        if prof:
            prof.start()
            spans.recording = True
        with tracing.window_span():
            t0 = time.perf_counter()
            n = 0
            while True:
                cell.rollout()
                n += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            sync()
            window_s = time.perf_counter() - t0
        trace = None
        if prof:
            spans.recording = False
            prof.stop()
            trace = tracing.reduce(tracing.raw_events(prof), window_s, spans)
            del prof
            print(f"portbench trace: {trace.device_ops} device ops, "
                  f"{trace.unattributed_ops} without a launch on the host; span device s "
                  f"{trace.span_device_s}; calls {trace.span_calls}", file=sys.stderr)
    finally:
        if spans:
            spans.uninstall()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    run = Run(cell, setup_s, window_s, n, n * cell.rows_per_rollout, trace)
    metrics = {}
    for m in metrics_of(manifest, name, traced):
        value = load_module(bench / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    cell.free_program()
    readings = cell.judge()
    failed = sum(1 for r in readings
                 if not all(math.isfinite(r[k]) and r[k] <= v for k, v in limits.items()))
    # a gap that is not finite prints as the largest float32, which JSON holds
    checks = {k: {"value": min(max(r[k] for r in readings), 3.4e38), "limit": v}
              for k, v in limits.items()}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": wl["chips"], "memory_peak_bytes": peak}
    if trace:
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
    result = {"correct": failed == 0, "attempted": n, "failed": failed, "metrics": metrics,
              "device": dev}
    if trace:
        result["breakdown"] = trace.breakdown()
    result["checks"] = checks
    return result


def print_result(result: Dict) -> None:
    """The checks as the last lines of standard error, then the result as the
    last line of standard output."""
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
