"""Environment construction from a config (counterpart of the custom-environment
part of ``mbrl_tpu/util/env.py:96-133``): ``cfg.overrides.env`` names the
environment, ``term_fn`` and ``reward_fn`` name the model-side functions, and
``trial_length`` caps every episode (:class:`~mbrl_tpu_torch.envs.time_limit.TimeLimit`,
as ``gymnasium.wrappers.TimeLimit`` does there).

The port builds only the environments it has; a MuJoCo environment, a
``gym___…``, ``pybulletgym___…`` or ``dmcontrol___…`` name raises ``NotImplementedError`` naming
the package it needs. The freeze/state handlers come with those environments.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

from mbrl_tpu_torch.envs import reward_fns as _reward_fns
from mbrl_tpu_torch.envs import termination_fns as _term_fns
from mbrl_tpu_torch.envs.time_limit import TimeLimit

# the JAX package's custom environments (mbrl_tpu/util/env.py:124-133) that
# run on MuJoCo: the port has their model-side functions, not the simulator
_MUJOCO_ENVS = (
    "pets_halfcheetah", "pets_cartpole", "cartpole_pets_version", "ant_truncated_obs",
    "humanoid_truncated_obs", "pets_pusher", "pets_reacher",
)


def _lookup_fn(module, name: Optional[str]) -> Optional[Callable]:
    if not name:
        return None
    return getattr(module, name, None)


def make_env_from_name(cfg, env_name: str):
    if env_name == "cartpole_continuous":
        from mbrl_tpu_torch.envs.cartpole_continuous import CartPoleEnv

        return CartPoleEnv()
    if "env_cfg" in cfg.overrides:
        from mbrl_tpu_torch.config import instantiate

        return instantiate(cfg.overrides.env_cfg)
    if env_name in _MUJOCO_ENVS:
        raise NotImplementedError(
            f"environment {env_name!r} needs `mujoco` (and `gymnasium`), which the port does "
            "not use yet; its model-side functions are in mbrl_tpu_torch.envs"
        )
    if env_name.startswith("gym___"):
        raise NotImplementedError(f"environment {env_name!r} needs `gymnasium`, which the port "
                                  "does not use yet")
    if env_name.startswith("pybulletgym___"):
        raise NotImplementedError(f"environment {env_name!r} needs `pybullet` and `pybulletgym`, "
                                  "which the port does not use yet")
    if env_name.startswith("dmcontrol___"):
        raise NotImplementedError(f"environment {env_name!r} needs `dm_control`, which the port "
                                  "does not use yet")
    raise ValueError(f"Unknown environment {env_name!r}")


def make_env(cfg) -> Tuple[object, Optional[Callable], Optional[Callable]]:
    """An environment, its termination function and its reward function (None
    with learned rewards) from ``cfg.overrides``; the environment capped at
    ``trial_length`` steps an episode when that is set."""
    term_fn = _lookup_fn(_term_fns, cfg.overrides.get("term_fn", None))
    reward_name = cfg.overrides.get("reward_fn", None) or cfg.overrides.get("term_fn", None)
    reward_fn = _lookup_fn(_reward_fns, reward_name)
    env = make_env_from_name(cfg, cfg.overrides.env)
    if cfg.overrides.get("learned_rewards", True):
        reward_fn = None
    if cfg.overrides.get("trial_length", None):
        env = TimeLimit(env, max_episode_steps=cfg.overrides.trial_length)
    return env, term_fn, reward_fn
