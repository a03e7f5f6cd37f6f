"""Training-state checkpointing (counterpart of ``mbrl_tpu/util/checkpoint.py``).

One atomic pickle of the FULL training state (model params, normalizer,
optimizer state, generator states, env-step counters) for mid-run resume.
Tensors are stored as numpy arrays and come back as tensors on the device asked
for. Where the JAX package stores a PRNG key, the port stores its generators'
states (:func:`generator_state` / :func:`set_generator_state`), as bytes.
"""
from __future__ import annotations

import pathlib
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from mbrl_tpu_torch.device import DeviceLike, resolve_device
from mbrl_tpu_torch.ops.tree import tree_leaves_with_path, tree_map

_CKPT_SUBDIR = "checkpoint"


def generator_state(generator: torch.Generator) -> bytes:
    """A host generator's state as bytes (a checkpoint leaf that stays as it is)."""
    return generator.get_state().numpy().tobytes()


def set_generator_state(generator: torch.Generator, state: bytes) -> None:
    generator.set_state(torch.frombuffer(bytearray(state), dtype=torch.uint8))


def _to_host(tree: Any) -> Any:
    return tree_map(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, tree
    )


class NonFiniteCheckpointError(ValueError):
    """A checkpoint payload (or a restored one) contains NaN/Inf float leaves."""


def validate_finite(tree: Any, what: str = "checkpoint state") -> None:
    """Refuse NaN/Inf training state: checkpointing is the last line of defense
    against persisting a diverged run. Checks every float array leaf and
    reports leaf paths."""
    bad = []
    for path, leaf in tree_leaves_with_path(tree):
        if isinstance(leaf, (bytes, str)):
            continue
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if arr.dtype.kind == "f" and arr.size and not np.isfinite(arr).all():
            bad.append("/".join(str(p) for p in path))
    if bad:
        raise NonFiniteCheckpointError(
            f"{what} contains non-finite values in {len(bad)} leaves "
            f"(e.g. {bad[:5]}); refusing to persist/restore a diverged model. "
            "Pass check_finite=False to override."
        )


def save_checkpoint(
    ckpt_dir,
    state: Dict[str, Any],
    step: int,
    keep: int = 3,
    check_finite: bool = True,
) -> pathlib.Path:
    """Atomically save a full training-state tree; prunes old checkpoints."""
    ckpt_dir = pathlib.Path(ckpt_dir) / _CKPT_SUBDIR
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    host = _to_host(state)
    if check_finite:
        validate_finite(host, "checkpoint state")
    tmp = ckpt_dir / f"step_{step}.tmp"
    final = ckpt_dir / f"step_{step}.pkl"
    with open(tmp, "wb") as f:
        pickle.dump(host, f)
    tmp.rename(final)
    _prune(ckpt_dir, keep)
    return final


def _step_of(path: pathlib.Path) -> int:
    return int(path.name.replace(".pkl", "").split("_")[1])


def _checkpoints(ckpt_dir: pathlib.Path):
    return sorted(
        [p for p in ckpt_dir.iterdir() if p.name.startswith("step_") and p.suffix == ".pkl"],
        key=_step_of,
    )


def _prune(ckpt_dir: pathlib.Path, keep: int) -> None:
    for old in _checkpoints(ckpt_dir)[:-keep]:
        old.unlink()


def latest_checkpoint(ckpt_dir) -> Optional[pathlib.Path]:
    ckpt_dir = pathlib.Path(ckpt_dir) / _CKPT_SUBDIR
    if not ckpt_dir.exists():
        return None
    ckpts = _checkpoints(ckpt_dir)
    return ckpts[-1] if ckpts else None


def restore_checkpoint(
    path, device: DeviceLike = "cuda", check_finite: bool = True
) -> Dict[str, Any]:
    """Load a checkpoint; array leaves return as tensors on ``device`` (Python
    scalars, strings and generator-state bytes as they were)."""
    dev = resolve_device(device)
    with open(pathlib.Path(path), "rb") as f:
        host = pickle.load(f)
    if check_finite:
        validate_finite(host, f"restored checkpoint {pathlib.Path(path).name}")

    def conv(x):
        if isinstance(x, (np.ndarray, np.generic)):
            return torch.as_tensor(np.asarray(x)).to(dev)
        return x

    return tree_map(conv, host)
