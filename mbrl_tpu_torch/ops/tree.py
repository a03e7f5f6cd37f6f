"""Helpers for nested containers of tensors (dicts, lists, tuples, dataclasses):
the port's parameter and state trees."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Tuple


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` applied to every leaf; dicts, lists, tuples and dataclasses are
    rebuilt, ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)}
        )
    return fn(tree)


def tree_leaves_with_path(tree: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in a fixed order (dict insertion order)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_path(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, path + (i,))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tree_leaves_with_path(getattr(tree, f.name), path + (f.name,))
    else:
        yield path, tree


def tree_set(tree: Any, path: Tuple, value: Any) -> Any:
    """A copy of ``tree`` (dicts and lists along ``path`` only) with the leaf at
    ``path`` replaced."""
    if not path:
        return value
    head, rest = path[0], path[1:]
    if isinstance(tree, dict):
        new = dict(tree)
        new[head] = tree_set(tree[head], rest, value)
        return new
    new = list(tree)
    new[head] = tree_set(tree[head], rest, value)
    return type(tree)(new) if isinstance(tree, tuple) else new
