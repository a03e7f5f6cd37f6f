"""The numbers that decide ``correct``, read over many seeds in one process:
for each seed, the program's (sound runs, the lower readings) and the
control's (the reference in the program's place, one precision down: TF32
products and a float32 normaliser; the upper readings), each at the cell's own
size and load. The limits in ``limits/<cell>.json`` are set from these. Not a
part of a benchmark run.

    python3 portbench/readings.py --workload mbpo_walker.rollout --seeds 1,2,3 \
        --control-seeds 1,2,3 [--rollouts 5] [--out FILE]
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def read(name: str, seed: int, mode: str, rollouts: int, device: str = "cuda",
         scale=None):
    import torch

    from portbench import harness

    _, _, config, terminated, traffic, driver = harness.load_cell(ROOT, name)
    cell = driver.Cell(config, traffic, seed, device, terminated, scale=scale, mode=mode)
    for _ in range(rollouts):
        cell.rollout()
    cell.free_program()
    out = cell.judge()
    del cell
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--rollouts", type=int, default=5)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    rows = []
    for mode, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for s in [int(x) for x in seeds.split(",") if x]:
            for r in read(args.workload, s, mode, args.rollouts):
                rows.append({"mode": mode, "seed": s, **r})
                print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for mode, pick in (("program", max), ("control", min)):
        got = [r for r in rows if r["mode"] == mode]
        if got:
            summary[mode] = {k: pick(r[k] for r in got) for k in ("rows_wrong", "action_gap",
                                                                   "model_gap")}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
