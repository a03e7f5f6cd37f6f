"""Environment construction from a config (counterpart of the custom-environment
part of ``mbrl_tpu/util/env.py:96-159``): ``cfg.overrides.env`` names the
environment, ``term_fn`` and ``reward_fn`` name the model-side functions, and
``trial_length`` caps every episode (:class:`~mbrl_tpu_torch.envs.time_limit.TimeLimit`,
as ``gymnasium.wrappers.TimeLimit`` does there).

Names resolve in the reference's order: a custom name, then
``overrides.env_cfg``, then the ``gym___``, ``pybulletgym___`` and
``dmcontrol___`` prefixes, then an environment registered in
:mod:`mbrl_tpu_torch.envs`. The port builds only the environments it has: a
``dmcontrol___<domain>--<task>`` name builds
:class:`~mbrl_tpu_torch.util.dmcontrol_wrapper.DmControlEnv` (``dm_control``
is imported then); a MuJoCo environment or a ``gym___`` or ``pybulletgym___``
name raises ``NotImplementedError`` naming the package it needs. The
freeze/state handlers come with those environments.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

from mbrl_tpu_torch import envs as _envs
from mbrl_tpu_torch.envs import reward_fns as _reward_fns
from mbrl_tpu_torch.envs import termination_fns as _term_fns
from mbrl_tpu_torch.envs.time_limit import TimeLimit

# the JAX package's custom environments (mbrl_tpu/util/env.py:124-133), by
# their class names in the envs package; all but the first run on MuJoCo
_CUSTOM_ENVS = {
    "cartpole_continuous": "CartPoleEnv",
    "pets_halfcheetah": "PetsHalfCheetahEnv",
    "pets_cartpole": "PetsCartPoleEnv",
    "cartpole_pets_version": "PetsCartPoleEnv",
    "ant_truncated_obs": "AntTruncatedObsEnv",
    "humanoid_truncated_obs": "HumanoidTruncatedObsEnv",
    "pets_pusher": "PetsPusherEnv",
    "pets_reacher": "PetsReacher3DEnv",
}


def _lookup_fn(module, name: Optional[str]) -> Optional[Callable]:
    if not name:
        return None
    return getattr(module, name, None)


def make_env_from_name(cfg, env_name: str):
    if env_name in _CUSTOM_ENVS:  # a MuJoCo one raises from the envs package
        return getattr(_envs, _CUSTOM_ENVS[env_name])()
    if "env_cfg" in cfg.overrides:
        from mbrl_tpu_torch.config import instantiate

        return instantiate(cfg.overrides.env_cfg)
    if env_name.startswith("gym___"):
        raise NotImplementedError(f"environment {env_name!r} needs `gymnasium`, which the port "
                                  "does not use yet")
    if env_name.startswith("pybulletgym___"):
        raise NotImplementedError(f"environment {env_name!r} needs `pybullet` and `pybulletgym`, "
                                  "which the port does not use yet")
    if env_name.startswith("dmcontrol___"):
        from mbrl_tpu_torch.util.dmcontrol_wrapper import DmControlEnv

        domain, task = env_name.split("___")[1].split("--")
        return DmControlEnv(
            domain,
            task,
            from_pixels=cfg.overrides.get("from_pixels", False),
            frame_skip=cfg.overrides.get("frame_skip", 1),
            bit_depth=cfg.overrides.get("bit_depth", 8),
        )
    # an environment registered in the envs package (the reference's hasattr
    # fallback); by membership, since a MuJoCo name raises NotImplementedError
    # there, which hasattr would pass on
    if env_name in _envs.ENVIRONMENTS or env_name in _envs.MUJOCO_ENVS:
        return getattr(_envs, env_name)()
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
