"""Runs one cell of the benchmark of ``mbrl_tpu_torch`` once, on the card(s) of
the machine it is started on, and prints one JSON line of results last on
standard output:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` measures the cell's end-to-end metrics with nothing traced;
``--trace 1`` wraps the functions named in ``portbench/spans/`` in spans,
profiles the window and reports the per-layer metrics. Either way the rows the
window wrote are compared with the plain reference afterwards (``correct``).
Exits with another code than 0, printing no result, without the cards the
cell asks for, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import sys
import time

_T0 = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent.parent


def process_age() -> float:
    """Seconds since this process started (its start time from /proc, where
    there is one), so that set-up counts the interpreter's start too."""
    try:
        fields = pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
        if 0.0 <= age < 3600.0:
            return age
    except (OSError, ValueError, IndexError, AttributeError):
        pass
    return time.perf_counter() - _T0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache the run may write stays at a fixed place inside the checkout
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench import harness

    age_imported = process_age()
    chips = harness.workload(harness.load_json(ROOT / "BENCHMARK.json"), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    age = process_age()
    print(f"portbench set-up: {age_imported:.3f} s to torch imported, {age:.3f} s to the "
          "card found", file=sys.stderr)
    t_start = time.perf_counter() - age
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_start=t_start)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"portbench: the process loaded {', '.join(foreign)}", file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
