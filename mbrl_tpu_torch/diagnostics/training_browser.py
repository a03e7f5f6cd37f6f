"""Training browser: plot results.csv curves across experiment directories
(counterpart of ``mbrl_tpu/diagnostics/training_browser.py``; host only).

Capability parity with the reference ``mbrl/diagnostics/training_browser.py``
(TrainingBrowser:154-373 — a PyQt5 GUI over results.csv files with multi-run
mean/std aggregation). Re-implemented headless-first with matplotlib: point it at
one or more experiment roots, it discovers every ``results.csv``, groups runs by
their config signature, and plots mean +/- std learning curves to a file (or shows
them interactively when a display is available). ``pandas`` and ``matplotlib``
are imported inside the functions that read and draw.
"""
from __future__ import annotations

import argparse
import pathlib
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


def find_results_files(roots: List[str]) -> List[pathlib.Path]:
    files: List[pathlib.Path] = []
    for root in roots:
        files.extend(pathlib.Path(root).rglob("results.csv"))
    return sorted(files)


def group_runs(files: List[pathlib.Path]) -> Dict[str, List[pathlib.Path]]:
    """Group runs by their <algo>/<experiment>/<env> path prefix (the run-dir
    layout written by mbrl_tpu_torch.examples.main)."""
    groups: Dict[str, List[pathlib.Path]] = defaultdict(list)
    for f in files:
        parts = f.parent.parts
        key = "/".join(parts[-5:-2]) if len(parts) >= 5 else str(f.parent)
        groups[key].append(f)
    return dict(groups)


def aggregate(
    files: List[pathlib.Path], x_key: str = "env_step", y_key: str = "episode_reward"
):
    """Interpolate every run's curve onto a common x grid; return (x, mean, std)."""
    import pandas as pd

    curves = []
    for f in files:
        df = pd.read_csv(f)
        if x_key not in df or y_key not in df or len(df) < 2:
            continue
        curves.append((df[x_key].to_numpy(float), df[y_key].to_numpy(float)))
    if not curves:
        return None
    x_min = max(c[0][0] for c in curves)
    x_max = min(c[0][-1] for c in curves)
    if x_max <= x_min:
        x_max = max(c[0][-1] for c in curves)
    grid = np.linspace(x_min, x_max, 200)
    ys = np.stack([np.interp(grid, x, y) for x, y in curves])
    return grid, ys.mean(axis=0), ys.std(axis=0)


def plot_groups(
    groups: Dict[str, List[pathlib.Path]],
    output: Optional[str] = None,
    y_key: str = "episode_reward",
):
    import matplotlib

    if output:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 6))
    for name, files in sorted(groups.items()):
        agg = aggregate(files, y_key=y_key)
        if agg is None:
            continue
        x, mean, std = agg
        (line,) = ax.plot(x, mean, label=f"{name} (n={len(files)})")
        ax.fill_between(x, mean - std, mean + std, alpha=0.2, color=line.get_color())
    ax.set_xlabel("env_step")
    ax.set_ylabel(y_key)
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    if output:
        fig.savefig(output, dpi=120, bbox_inches="tight")
        print(f"Saved plot to {output}")
    else:
        plt.show()
    return fig


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("roots", nargs="+", help="experiment root directories")
    parser.add_argument("--output", type=str, default=None, help="save plot here")
    parser.add_argument("--y", type=str, default="episode_reward")
    args = parser.parse_args()
    files = find_results_files(args.roots)
    if not files:
        print("No results.csv files found.")
        return
    plot_groups(group_runs(files), output=args.output, y_key=args.y)


if __name__ == "__main__":
    main()
