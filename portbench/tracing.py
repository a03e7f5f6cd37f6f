"""Spans and the device trace of a traced run (``--trace 1``).

Spans come from the benchmark's own files: each ``spans/<layer>.json`` names
functions of the port (``module:function`` or ``module:Class.method``) that a
traced run wraps in ``torch.profiler.record_function``; the wrapper also
counts the calls and, where the file asks, keeps the shapes of the tensor
arguments (other arguments by reference). Untraced runs wrap nothing.

The profiler's raw events are reduced to what the metric readers read: each
device operation's time and the spans open on the host when it was launched
(by the launch's correlation id), the union of device time, the operations
that took most time, and the device's idle gaps by the span the host was in.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import heapq
import importlib
import json
import pathlib
import re
from typing import Dict

import torch

from portbench.yardstick import busy_union

WINDOW_SPAN = "portbench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


def _describe(value):
    if isinstance(value, torch.Tensor):
        return ("tensor", tuple(value.shape), value.element_size())
    return value


class Spans:
    """The wrappers of one run; ``calls`` and ``args`` fill only while
    ``recording`` is set (the measured window)."""

    def __init__(self, bench_dir: pathlib.Path):
        self.specs = []
        for path in sorted((bench_dir / "spans").glob("*.json")):
            for spec in json.loads(path.read_text())["spans"]:
                self.specs.append(spec)
        self.names = [spec["name"] for spec in self.specs]
        self.calls: Dict[str, int] = collections.Counter()
        self.args: Dict[str, list] = collections.defaultdict(list)
        self.recording = False
        self._undo = []

    def _wrap(self, name: str, fn, keep_args: bool):
        spans = self

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if spans.recording:
                spans.calls[name] += 1
                if keep_args:
                    spans.args[name].append(
                        ([_describe(a) for a in args],
                         {k: _describe(v) for k, v in kwargs.items()}))
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    def install(self) -> None:
        for spec in self.specs:
            module_name, attr = spec["target"].split(":")
            owner = importlib.import_module(module_name)
            *path, leaf = attr.split(".")
            for part in path:
                owner = getattr(owner, part)
            raw = getattr(owner, leaf)
            setattr(owner, leaf, self._wrap(spec["name"], raw, spec.get("args", False)))
            self._undo.append((owner, leaf, raw))

    def uninstall(self) -> None:
        for owner, leaf, raw in reversed(self._undo):
            setattr(owner, leaf, raw)
        self._undo.clear()


@dataclasses.dataclass
class Trace:
    """A traced window, reduced."""

    window_s: float
    busy_s: float
    device_ops: int
    unattributed_ops: int
    span_device_s: Dict[str, float]  # device time of the ops launched inside each span
    span_calls: Dict[str, int]
    span_args: Dict[str, list]
    by_name: Dict[str, float]  # device seconds by operation name
    idle_by_span: Dict[str, float]  # idle device seconds by the host's innermost span

    def breakdown(self) -> Dict[str, list]:
        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

        return {"device_ops": top(self.by_name), "idle_gaps": top(self.idle_by_span)}


def _short(name: str) -> str:
    """A device operation's name without its argument list, cut to 64
    characters."""
    return name.split("(")[0][:64]


def _open_at(queries, spans):
    """For each ``(time, key)`` query in time order, the ``(start, name)`` of
    the spans (``(start, end, name)``, sorted) open at that time, innermost
    last."""
    heap, k, out = [], 0, {}
    for t, key in queries:
        while k < len(spans) and spans[k][0] <= t:
            s, e, name = spans[k]
            heapq.heappush(heap, (e, s, name))
            k += 1
        while heap and heap[0][0] < t:
            heapq.heappop(heap)
        out[key] = sorted((s, name) for _, s, name in heap)
    return out


_API = re.compile(r"^cu(da)?[A-Z]")


def _classify(e, span_names) -> str:
    """An event's kind: ``activity_type()`` where the profiler has it, else
    from its device and name (a span is one of ours, a launch is a CUDA
    runtime or driver call)."""
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
        if kind == "user_annotation":
            return "span"
        if kind in LAUNCH_KINDS:
            return "launch"
        return "device" if kind in DEVICE_KINDS else "op"
    on_device = e.device_type() == torch.autograd.DeviceType.CUDA
    if e.name() in span_names or e.name().startswith("portbench."):
        return "projected" if on_device else "span"
    if on_device:
        return "device"
    return "launch" if _API.match(e.name()) else "op"


def reduce(events, window_s: float, spans: Spans) -> Trace:
    """Reduce the profiler's raw events (``kineto_results.events()``): records
    with ``name()``, ``start_ns()``, ``end_ns()``, ``correlation_id()``,
    ``linked_correlation_id()``, ``start_thread_id()``, ``device_type()`` and,
    in newer PyTorch, ``activity_type()``. A device operation belongs to the
    spans open when its launch ran (the launch's correlation id), or when the
    host operation it is linked to began."""
    span_names = set(spans.names) | {WINDOW_SPAN}
    host, launches, ops, device = [], {}, {}, []
    for e in events:
        kind = _classify(e, span_names)
        if kind == "span":
            host.append((e.start_ns(), e.end_ns(), e.name(), e.start_thread_id()))
            ops[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
        elif kind == "launch":
            launches[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
        elif kind == "op":
            ops[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
        elif kind == "device":
            device.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id(),
                           e.linked_correlation_id()))
    window = [h for h in host if h[2] == WINDOW_SPAN]
    if not window:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window[0][0], window[0][1]
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    by_thread = collections.defaultdict(list)
    for s, e, name, tid in host:
        if name != WINDOW_SPAN:
            by_thread[tid].append((s, e, name))
    for lst in by_thread.values():
        lst.sort()

    # the spans open on the host when each device operation was launched
    queries = collections.defaultdict(list)
    found = 0
    for i, d in enumerate(device):
        at = launches.get(d[3]) if d[3] > 0 else None
        if at is None and d[4] > 0:  # 0: no link
            at = ops.get(d[4])
        if at is not None:
            queries[at[1]].append((at[0], i))
            found += 1
    owners: Dict[int, list] = {}
    for tid, qs in queries.items():
        owners.update(_open_at(sorted(qs), by_thread[tid]))
    span_s: Dict[str, float] = collections.defaultdict(float)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for i, (s, e, name, _, _) in enumerate(device):
        dur = (min(e, w1) - max(s, w0)) / 1e9
        by_name[_short(name)] += dur
        for n in {n for _, n in owners.get(i, ())}:
            span_s[n] += dur
    intervals = sorted((max(s, w0), min(e, w1)) for s, e, *_ in device)

    # the device's idle gaps, by the innermost span of the busiest host thread
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    edges = [w0] + [x for m in merged for x in m] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    main = max(by_thread, key=lambda tid: len(by_thread[tid])) if by_thread else None
    at_gap = _open_at([(g0, k) for k, (g0, _) in enumerate(gaps)], by_thread.get(main, []))
    idle: Dict[str, float] = collections.defaultdict(float)
    for k, (g0, g1) in enumerate(gaps):
        open_ = at_gap[k]
        idle[open_[-1][1] if open_ else "outside_spans"] += (g1 - g0) / 1e9
    return Trace(window_s=window_s, busy_s=busy_union(intervals) / 1e9, device_ops=len(device),
                 unattributed_ops=len(device) - found,
                 span_device_s=dict(span_s), span_calls=dict(spans.calls),
                 span_args=dict(spans.args), by_name=dict(by_name), idle_by_span=dict(idle))


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def raw_events(prof) -> list:
    return prof.profiler.kineto_results.events()


def window_span():
    return torch.profiler.record_function(WINDOW_SPAN)
