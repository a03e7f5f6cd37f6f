"""CSV + console group logger.

Counterpart of ``mbrl_tpu/util/logger.py`` (standard library only): named
logging groups registered with (key, shortcut, type) format triples;
``log_data`` appends a row per call to ``<group>.csv`` in the results dir and
pretty-prints to the console; averaging meters with a dump frequency support
high-frequency producers. The CSV schema is the JAX package's.
"""
from __future__ import annotations

import csv
import pathlib
from collections import defaultdict
from typing import Any, Dict, Mapping, Sequence, Tuple, Union

LogFormatType = Sequence[Tuple[str, str, str]]

_COLOR_CODES = {
    "green": 32,
    "blue": 34,
    "yellow": 33,
    "red": 31,
    "cyan": 36,
    "magenta": 35,
    "white": 37,
}


class _Averager:
    def __init__(self):
        self._sum: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    def add(self, data: Mapping[str, Any]) -> None:
        for k, v in data.items():
            self._sum[k] += float(v)
            self._count[k] += 1

    def mean_and_clear(self) -> Dict[str, float]:
        out = {k: self._sum[k] / max(self._count[k], 1) for k in self._sum}
        self._sum.clear()
        self._count.clear()
        return out

    def __len__(self):
        return sum(self._count.values())


class Logger:
    """Group-structured CSV/console logger."""

    def __init__(self, log_dir: Union[str, pathlib.Path], enable_back_compat: bool = False):
        self.log_dir = pathlib.Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._groups: Dict[str, Dict[str, Any]] = {}
        self._back_compat = enable_back_compat
        self._averagers: Dict[str, _Averager] = {}

    def register_group(
        self,
        name: str,
        log_format: LogFormatType,
        dump_frequency: int = 1,
        color: str = "white",
        disable_console_dump: bool = False,
    ) -> None:
        if name in self._groups:
            return
        path = self.log_dir / f"{name}.csv"
        file = open(path, "a", newline="")
        writer = csv.DictWriter(file, fieldnames=[k for k, _, _ in log_format])
        if path.stat().st_size == 0:
            writer.writeheader()
            file.flush()
        self._groups[name] = {
            "format": list(log_format),
            "file": file,
            "writer": writer,
            "dump_frequency": dump_frequency,
            "color": color,
            "console": not disable_console_dump,
            "pending": 0,
        }
        self._averagers[name] = _Averager()

    def log_data(self, group_name: str, data: Mapping[str, Any]) -> None:
        """Append one row; rows are averaged and flushed every dump_frequency calls."""
        group = self._groups[group_name]
        avg = self._averagers[group_name]
        avg.add({k: data.get(k, 0) for k, _, _ in group["format"]})
        group["pending"] += 1
        if group["pending"] >= group["dump_frequency"]:
            self._dump(group_name)

    def _dump(self, group_name: str) -> None:
        group = self._groups[group_name]
        row = self._averagers[group_name].mean_and_clear()
        if not row:
            return
        typed_row = {}
        for key, _, typ in group["format"]:
            val = row.get(key, 0)
            typed_row[key] = int(val) if typ == "int" else val
        group["writer"].writerow(typed_row)
        group["file"].flush()
        group["pending"] = 0
        if group["console"]:
            self._print_row(group_name, typed_row)

    def _print_row(self, group_name: str, row: Mapping[str, Any]) -> None:
        group = self._groups[group_name]
        code = _COLOR_CODES.get(group["color"], 37)
        pieces = []
        for key, shortcut, typ in group["format"]:
            val = row.get(key, 0)
            if typ == "float":
                pieces.append(f"{shortcut}: {val:.4f}")
            elif typ == "time":
                pieces.append(f"{shortcut}: {val:.1f}s")
            else:
                pieces.append(f"{shortcut}: {val}")
        print(f"\033[{code}m| {group_name} | " + " | ".join(pieces) + "\033[0m")

    def close(self) -> None:
        for group in self._groups.values():
            group["file"].close()

    # ----- pytorch_sac-style back-compat shims -----
    def log(self, key: str, value: Any, step: int) -> None:
        group_name, key_name = key.split("/", 1)
        if group_name not in self._groups:
            return
        self._averagers[group_name].add({key_name: value})

    def dump(self, step: int, save: bool = True) -> None:
        for name in self._groups:
            if len(self._averagers[name]):
                self._dump(name)

    def log_histogram(self, *args, **kwargs) -> None:
        pass

    def log_param(self, *args, **kwargs) -> None:
        pass
