"""Lightweight Hydra-style configuration engine (YAML groups, ${} interpolation,
_target_ instantiation); counterpart of ``mbrl_tpu/config/engine.py``.

``pyyaml`` is imported where YAML text is parsed, not with this module: a
``Config`` built from a dict, interpolation and instantiation need none of it.

  - config groups composed via a ``defaults`` list in the primary config
    (``defaults: [{algorithm: pets}, {dynamics_model: gaussian_mlp_ensemble}, ...]``);
  - ``${a.b.c}`` interpolation across groups, resolved after composition;
  - ``_target_``-driven instantiation of models/agents/optimizers/envs by dotted
    import path, with recursive instantiation of nested ``_target_`` nodes;
  - ``???`` mandatory fields completed at runtime (e.g. from env shapes);
  - dotted CLI overrides: ``algorithm=mbpo overrides=mbpo_halfcheetah``
    (group swaps) and ``dynamics_model.model.ensemble_size=5`` (value sets).
"""
from __future__ import annotations

import copy
import importlib
import pathlib
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

MISSING = "???"
_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class Config:
    """Attribute/index hybrid view over a nested dict (mutable)."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", data if data is not None else {})

    # -- access ---------------------------------------------------------- #
    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            # never route private/dunder lookups through the data dict: pickle
            # probes __reduce_ex__/__getstate__ before _data exists and the
            # fallback would recurse through __getitem__ forever
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    # -- pickling (spawn/forkserver env workers ship their cfg) ----------- #
    def __getstate__(self) -> Dict[str, Any]:
        return {"_data": self._data}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        object.__setattr__(self, "_data", state["_data"])

    def __getitem__(self, key: str) -> Any:
        val = self._data[key]
        if val == MISSING:
            raise ValueError(f"Mandatory config field '{key}' is missing (???)")
        return Config(val) if isinstance(val, dict) else val

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, Config):
            value = value._data
        self._data[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        if key not in self._data:
            return default
        val = self._data[key]
        if val == MISSING:
            return default
        return Config(val) if isinstance(val, dict) else val

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def keys(self):
        return self._data.keys()

    def items(self):
        for k in self._data:
            yield k, self[k]

    def __iter__(self):
        return iter(self._data)

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self._data))

    def set_path(self, dotted: str, value: Any) -> None:
        node = self._data
        parts = dotted.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self._data
        for p in dotted.split("."):
            if not isinstance(node, dict) or p not in node:
                return default
            node = node[p]
        return node


def to_dict(cfg: Union[Config, Dict[str, Any]]) -> Dict[str, Any]:
    return copy.deepcopy(cfg._data if isinstance(cfg, Config) else cfg)


# ------------------------------------------------------------------------- #
# Composition
# ------------------------------------------------------------------------- #
_NUMERIC_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _coerce_numbers(node: Any) -> Any:
    """PyYAML (YAML 1.1) parses '3e-5' as a string; coerce such scientific-notation
    strings to floats everywhere in the tree."""
    if isinstance(node, dict):
        return {k: _coerce_numbers(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_coerce_numbers(v) for v in node]
    if isinstance(node, str) and _NUMERIC_RE.match(node):
        return float(node)
    return node


def _load_yaml(path: pathlib.Path) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return _coerce_numbers(yaml.safe_load(f) or {})


def load_yaml_file(path: Union[str, pathlib.Path]) -> Config:
    """One YAML file as a ``Config``, as it stands: no defaults list is
    composed and no interpolation resolved (a run's saved ``config.yaml``)."""
    return Config(_load_yaml(pathlib.Path(path)))


def _merge(dst: Dict[str, Any], src: Mapping[str, Any]) -> Dict[str, Any]:
    for k, v in src.items():
        if isinstance(v, Mapping) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def parse_overrides(overrides: Sequence[str]) -> Tuple[Dict[str, str], List[Tuple[str, Any]]]:
    """Split CLI-style overrides into (group swaps, dotted value sets)."""
    import yaml

    groups: Dict[str, str] = {}
    values: List[Tuple[str, Any]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override {ov!r} must be key=value")
        key, raw = ov.split("=", 1)
        if "." in key:
            values.append((key, yaml.safe_load(raw)))
        else:
            groups[key] = raw
    return groups, values


def load_config(
    config_dir: Union[str, pathlib.Path],
    config_name: str = "main",
    overrides: Sequence[str] = (),
) -> Config:
    """Compose the primary config with its defaults list and apply overrides.

    Group entries in ``defaults`` load ``<config_dir>/<group>/<choice>.yaml`` into
    ``cfg.<group>``; group choices can be swapped from the CLI (``algorithm=mbpo``);
    dotted overrides set values. ``${}`` interpolations resolve afterwards.
    """
    config_dir = pathlib.Path(config_dir)
    primary = _load_yaml(config_dir / f"{config_name}.yaml")
    defaults = primary.pop("defaults", [])
    group_swaps, value_sets = parse_overrides(overrides)

    data: Dict[str, Any] = {}
    for entry in defaults:
        if isinstance(entry, str):
            if entry == "_self_":
                _merge(data, primary)
            continue
        (group, choice), = entry.items()
        choice = group_swaps.pop(group, choice)
        group_file = config_dir / group / f"{choice}.yaml"
        if not group_file.exists():
            raise FileNotFoundError(
                f"Config group file not found: {group_file} "
                f"(group {group!r}, choice {choice!r})"
            )
        data.setdefault(group, {})
        _merge(data[group], _load_yaml(group_file))
    _merge(data, primary)

    # leftover group swaps may target groups not in defaults
    for group, choice in group_swaps.items():
        group_file = config_dir / group / f"{choice}.yaml"
        if group_file.exists():
            data[group] = _load_yaml(group_file)
        else:
            import yaml

            data[group] = yaml.safe_load(choice)

    cfg = Config(data)
    for dotted, value in value_sets:
        cfg.set_path(dotted, value)
    resolve_interpolations(cfg)
    return cfg


# ------------------------------------------------------------------------- #
# Interpolation
# ------------------------------------------------------------------------- #
def resolve_interpolations(cfg: Config, max_passes: int = 10) -> None:
    """Resolve ``${dotted.path}`` references in-place against the config root."""
    root = cfg._data

    _ABSENT = object()

    def resolve_value(val: Any) -> Any:
        if not isinstance(val, str):
            return val
        full = _INTERP_RE.fullmatch(val)
        if full:
            ref = cfg.get_path(full.group(1), _ABSENT)
            # leave the interpolation in place if the target doesn't exist yet —
            # callers may fill it and re-resolve later
            return val if ref is _ABSENT else ref

        def sub(m):
            ref = cfg.get_path(m.group(1), _ABSENT)
            return m.group(0) if ref is _ABSENT else str(ref)

        return _INTERP_RE.sub(sub, val) if _INTERP_RE.search(val) else val

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return resolve_value(node)

    for _ in range(max_passes):
        new = walk(root)
        if new == root:
            break
        root.clear()
        root.update(new)


# ------------------------------------------------------------------------- #
# Instantiation
# ------------------------------------------------------------------------- #
def _import_target(target: str) -> Any:
    """Import a dotted path; walks attributes past the longest importable module
    prefix (supports e.g. ``pkg.mod.Class.staticmethod``)."""
    parts = target.split(".")
    for i in range(len(parts) - 1, 0, -1):
        module_name = ".".join(parts[:i])
        try:
            obj = importlib.import_module(module_name)
        except ImportError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(f"Cannot import target {target!r}")


def instantiate(node: Union[Config, Dict[str, Any]], **extra_kwargs) -> Any:
    """Instantiate a ``_target_`` node: import the dotted path, recursively
    instantiate nested ``_target_`` children, call with merged kwargs."""
    data = to_dict(node)
    if "_target_" not in data:
        raise ValueError(f"instantiate() requires a _target_ key, got {data.keys()}")
    target = _import_target(data.pop("_target_"))
    data.pop("_recursive_", None)
    data.pop("_partial_", None)
    kwargs = {}
    for k, v in data.items():
        if isinstance(v, dict) and "_target_" in v:
            kwargs[k] = instantiate(v)
        else:
            if v == MISSING:
                raise ValueError(f"Mandatory field {k!r} (???) not filled before instantiate")
            if isinstance(v, str) and _INTERP_RE.search(v):
                raise ValueError(
                    f"Field {k!r} contains an unresolved interpolation {v!r} — the "
                    "referenced config path does not exist (check override names)"
                )
            kwargs[k] = v
    kwargs.update(extra_kwargs)
    return target(**kwargs)
