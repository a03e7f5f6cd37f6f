"""Profiling and tracing hooks (counterpart of ``mbrl_tpu/util/profiling.py``).

  - :func:`trace` — context manager around ``torch.profiler`` (host and, where
    there is a card, device activity) writing a Chrome trace of the enclosed
    region into ``log_dir`` (open it in Perfetto or ``chrome://tracing``);
  - :func:`annotate` — a named range (``torch.profiler.record_function``) that
    attributes the enclosed work to a framework phase (plan / model-train /
    sac-update / rollout), or to a layer of the imagined rollout; with no
    profiler recording it costs one flag check and records nothing;
  - :func:`span` — the same range around every call of a function;
  - :class:`StepTimer` — wall-clock phase timer with summary statistics, for
    loops where a full trace is too heavy.
"""
from __future__ import annotations

import contextlib
import functools
import os
import pathlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from mbrl_tpu_torch.ops.tree import tree_leaves_with_path


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region and write it to
    ``log_dir/trace_<pid>_<ns>.json`` (Chrome trace format) when it ends.
    Device activity is recorded when CUDA is available. Yields the profiler,
    whose ``events()`` and ``key_averages()`` the caller may read."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out_dir = pathlib.Path(log_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(out_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"))


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """Named range attributing enclosed host and device work to a framework
    phase. While a profiler records (``torch.profiler``, ``emit_nvtx``), a
    ``torch.profiler.record_function`` on the profiler's timeline, the clock
    its device records are aligned to; otherwise a shared no-op context: no
    ``RecordFunction``, no dispatcher call."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


def span(name: str):
    """Decorator: every call of the function is the range ``name``
    (:func:`annotate`); off the profiler, one flag check and one call."""

    def decorate(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:  # annotate's check, inlined
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return spanned

    return decorate


def _synchronize(block) -> None:
    """Wait for the devices holding the tensors in ``block`` (a tensor or a
    nested list, tuple or dict of them)."""
    devices = {leaf.device for _, leaf in tree_leaves_with_path(block)
               if isinstance(leaf, torch.Tensor)}
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


class StepTimer:
    """Accumulates wall-clock timings per named phase.

    Device work is asynchronous; wrap regions whose results you block on, or pass
    ``block=`` the tensors (any nesting) to synchronize on before stopping the clock.
    """

    def __init__(self):
        self._times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, block=None) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            if block is not None:
                _synchronize(block)
            self._times[name].append(time.perf_counter() - start)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self._times.items():
            arr = np.asarray(ts)
            out[name] = {
                "count": int(arr.size),
                "total_s": float(arr.sum()),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p95_ms": float(np.percentile(arr, 95) * 1e3),
            }
        return out

    def report(self) -> str:
        lines = [f"{'phase':<20} {'count':>6} {'total_s':>9} {'mean_ms':>9} {'p95_ms':>9}"]
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:<20} {s['count']:>6} {s['total_s']:>9.2f} "
                f"{s['mean_ms']:>9.2f} {s['p95_ms']:>9.2f}"
            )
        return "\n".join(lines)

    def clear(self) -> None:
        self._times.clear()
