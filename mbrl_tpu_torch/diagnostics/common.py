"""Shared loader for experiment result directories (counterpart of
``mbrl_tpu/diagnostics/common.py``).

The run dir (written by ``mbrl_tpu_torch.examples.main``, or by the JAX
package's) is the source of truth for reconstruction, mirroring the
reference's reload-from-Hydra-dir convention (mbrl/util/common.py:113-130):
``config.yaml`` + ``model.pkl`` (+ normalizer stats) + ``replay_buffer.npz``.

:func:`load_run_config` is the only reader of a run's ``config.yaml``; every
loader here and in ``planning.core.load_agent`` and ``util.huggingface`` takes
a keyword-only ``cfg`` (the run's composed ``Config``) that, when given,
replaces that read, and a ``device`` (default ``"cuda"``) for what it builds.
"""
from __future__ import annotations

import pathlib
from typing import Any, Dict, Optional, Tuple

import torch

from mbrl_tpu_torch.config import Config, create_one_dim_tr_model
from mbrl_tpu_torch.config.engine import load_yaml_file
from mbrl_tpu_torch.device import DeviceLike
from mbrl_tpu_torch.util import common as util_common
from mbrl_tpu_torch.util.env import create_handler

_JAX_PACKAGE = "mbrl_tpu."


def _port_paths(node: Any) -> Any:
    """The JAX package's dotted paths (``_target_``s, ``obs_process_fn``) in a
    run config it wrote, named as this package's counterparts."""
    if isinstance(node, dict):
        return {k: _port_paths(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_port_paths(v) for v in node]
    if isinstance(node, str) and node.startswith(_JAX_PACKAGE):
        return "mbrl_tpu_torch." + node[len(_JAX_PACKAGE):]
    return node


def load_run_config(results_dir) -> Config:
    """The run's ``config.yaml`` (or ``.hydra/config.yaml``), read through the
    config engine's YAML loader; a dotted path into the JAX package names
    this package's counterpart."""
    results_dir = pathlib.Path(results_dir)
    cfg_file = results_dir / "config.yaml"
    if not cfg_file.exists():
        cfg_file = results_dir / ".hydra" / "config.yaml"
    return Config(_port_paths(load_yaml_file(cfg_file)._data))


def load_experiment(
    results_dir, load_buffer: bool = True, *, cfg: Optional[Config] = None,
    device: DeviceLike = "cuda",
) -> Tuple[Config, Any, Any, Dict[str, Any], Optional[Any], Any, Any]:
    """Reconstruct (cfg, env, dynamics wrapper, wrapper state, replay buffer,
    term_fn, reward_fn) from a results directory; the model on ``device``."""
    results_dir = pathlib.Path(results_dir)
    cfg = load_run_config(results_dir) if cfg is None else cfg
    handler = create_handler(cfg)
    env, term_fn, reward_fn = handler.make_env(cfg)
    obs_shape = env.observation_space.shape
    act_shape = env.action_space.shape

    wrapper = create_one_dim_tr_model(cfg, obs_shape, act_shape, device=device)
    state = wrapper.init(torch.Generator().manual_seed(cfg.get("seed", 0) or 0))
    state = wrapper.load(state, results_dir)

    buffer = None
    if load_buffer and (results_dir / "replay_buffer.npz").exists():
        buffer = util_common.create_replay_buffer(
            cfg, obs_shape, act_shape, load_dir=results_dir
        )
    return cfg, env, wrapper, state, buffer, term_fn, reward_fn
