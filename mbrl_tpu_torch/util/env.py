"""Environment construction from a config and the state freeze/get/set
handlers (counterpart of ``mbrl_tpu/util/env.py``).

``cfg.overrides.env`` names the environment, ``term_fn`` and ``reward_fn`` name
the model-side functions, and ``trial_length`` caps every episode
(:class:`~mbrl_tpu_torch.envs.time_limit.TimeLimit`, where the JAX package
wraps ``gymnasium.wrappers.TimeLimit``). Names resolve in the reference's
order: a custom name, then ``overrides.env_cfg``, then the ``gym___``,
``pybulletgym___`` and ``dmcontrol___`` prefixes, then an environment
registered in :mod:`mbrl_tpu_torch.envs`. ``gymnasium``, ``mujoco`` and
``dm_control`` are imported when an environment that needs them is made, and
a ``pybulletgym___`` name raises ``NotImplementedError`` (no ``pybullet``).

The handlers capture and restore an environment's physics state (MuJoCo's
qpos and qvel, dm_control's physics state, or a plain environment's
attributes) and roll the real environment out inside such a freeze. They take
the environment bare, in ``gymnasium``'s ``TimeLimit`` or in the port's.
"""
from __future__ import annotations

import abc
import copy
from typing import Callable, Optional, Tuple

import numpy as np

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
_MUJOCO_NAMES = tuple(name for name in _CUSTOM_ENVS if name != "cartpole_continuous")
_MUJOCO_GYM_TOKENS = ("HalfCheetah", "Hopper", "Walker", "Ant", "Humanoid", "Inverted", "Reacher",
                      "Pusher", "Swimmer")


def _lookup_fn(module, name: Optional[str]) -> Optional[Callable]:
    if not name:
        return None
    return getattr(module, name, None)


def _unwrapped(env):
    return getattr(env, "unwrapped", env)


def make_env_from_name(cfg, env_name: str):
    if env_name in _CUSTOM_ENVS:
        return getattr(_envs, _CUSTOM_ENVS[env_name])()
    if "env_cfg" in cfg.overrides:
        from mbrl_tpu_torch.config import instantiate

        return instantiate(cfg.overrides.env_cfg)
    if env_name.startswith("gym___"):
        import gymnasium

        return gymnasium.make(env_name.split("___")[1])
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
    # an environment registered in the envs package (the reference's hasattr fallback)
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


# --------------------------------------------------------------------------- #
# Handlers
# --------------------------------------------------------------------------- #
class Freeze(abc.ABC):
    """Context manager capturing and restoring an environment's state."""

    def __enter__(self):
        raise NotImplementedError

    def __exit__(self, *args):
        raise NotImplementedError


class EnvHandler(abc.ABC):
    """Backend-neutral environment utilities."""

    freeze = Freeze

    @staticmethod
    @abc.abstractmethod
    def is_correct_env_type(env) -> bool:
        ...

    @staticmethod
    @abc.abstractmethod
    def make_env_from_str(env_name: str):
        ...

    @staticmethod
    @abc.abstractmethod
    def get_current_state(env) -> Tuple:
        ...

    @staticmethod
    @abc.abstractmethod
    def set_env_state(state: Tuple, env) -> None:
        ...

    @classmethod
    def rollout_env(
        cls, env, initial_obs: np.ndarray, lookahead: int, agent=None, plan=None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The real environment's observations, rewards and actions over
        ``lookahead`` steps (or along ``plan``), inside a freeze, so the
        environment ends where it started."""
        actions, real_obses, rewards = [], [], []
        with cls.freeze(env):  # type: ignore[call-arg]
            current_obs = initial_obs.copy()
            real_obses.append(current_obs)
            if plan is not None:
                lookahead = len(plan)
            for i in range(lookahead):
                a = plan[i] if plan is not None else agent.act(current_obs)
                if isinstance(a, np.ndarray) and a.ndim == 0:
                    a = a[None]
                next_obs, reward, terminated, truncated, _ = env.step(a)
                actions.append(a)
                real_obses.append(next_obs)
                rewards.append(reward)
                if terminated or truncated:
                    break
                current_obs = next_obs
        return np.stack(real_obses), np.stack(rewards), np.stack(actions)

    @classmethod
    def make_env(cls, cfg) -> Tuple[object, Optional[Callable], Optional[Callable]]:
        """:func:`make_env`: the environment, termination and reward functions
        from ``cfg.overrides``."""
        return make_env(cfg)


class GenericEnvHandler(EnvHandler):
    """A plain environment without physics state access: its attributes."""

    class freeze(Freeze):  # noqa: N801 — a context manager named like the attribute
        def __init__(self, env):
            self.env = env
            self._state = None

        def __enter__(self):
            self._state = copy.deepcopy(_unwrapped(self.env).__dict__)
            return self

        def __exit__(self, *args):
            _unwrapped(self.env).__dict__.update(self._state)

    @staticmethod
    def is_correct_env_type(env) -> bool:
        return True

    @staticmethod
    def make_env_from_str(env_name: str):
        import gymnasium

        return gymnasium.make(env_name)

    @staticmethod
    def get_current_state(env) -> Tuple:
        return (copy.deepcopy(_unwrapped(env).__dict__),)

    @staticmethod
    def set_env_state(state: Tuple, env) -> None:
        _unwrapped(env).__dict__.update(state[0])


class MujocoEnvHandler(EnvHandler):
    """qpos and qvel get and set, and the step count kept by a freeze, for
    ``gymnasium`` MuJoCo environments."""

    class freeze(Freeze):  # noqa: N801
        def __init__(self, env):
            self.env = env
            self._state = None
            self._elapsed_steps = 0

        def __enter__(self):
            self._state = MujocoEnvHandler.get_current_state(self.env)
            self._elapsed_steps = getattr(self.env, "_elapsed_steps", 0)
            return self

        def __exit__(self, *args):
            MujocoEnvHandler.set_env_state(self._state, self.env)
            if hasattr(self.env, "_elapsed_steps"):
                self.env._elapsed_steps = self._elapsed_steps

    @staticmethod
    def is_correct_env_type(env) -> bool:
        unwrapped = _unwrapped(env)
        return hasattr(unwrapped, "data") and hasattr(unwrapped, "model")

    @staticmethod
    def make_env_from_str(env_name: str):
        import gymnasium

        return gymnasium.make(env_name)

    @staticmethod
    def get_current_state(env) -> Tuple:
        unwrapped = _unwrapped(env)
        return unwrapped.data.qpos.copy(), unwrapped.data.qvel.copy()

    @staticmethod
    def set_env_state(state: Tuple, env) -> None:
        qpos, qvel = state
        _unwrapped(env).set_state(qpos, qvel)


class DmcontrolEnvHandler(EnvHandler):
    """dm_control's ``physics.get_state``/``set_state`` for environments made
    by :mod:`mbrl_tpu_torch.util.dmcontrol_wrapper`."""

    class freeze(Freeze):  # noqa: N801
        def __init__(self, env):
            self.env = env
            self._state = None

        def __enter__(self):
            self._state = DmcontrolEnvHandler.get_current_state(self.env)
            return self

        def __exit__(self, *args):
            DmcontrolEnvHandler.set_env_state(self._state, self.env)

    @staticmethod
    def is_correct_env_type(env) -> bool:
        return hasattr(getattr(_unwrapped(env), "_env", None), "physics")

    @staticmethod
    def make_env_from_str(env_name: str):
        from mbrl_tpu_torch.util.dmcontrol_wrapper import DmControlEnv

        domain, task = env_name.split("___")[1].split("--")
        return DmControlEnv(domain, task)

    @staticmethod
    def get_current_state(env) -> Tuple:
        return (_unwrapped(env)._env.physics.get_state().copy(),)

    @staticmethod
    def set_env_state(state: Tuple, env) -> None:
        physics = _unwrapped(env)._env.physics
        with physics.reset_context():
            physics.set_state(state[0])


def create_handler(cfg) -> EnvHandler:
    """A handler for the environment the config names."""
    return create_handler_from_str(cfg.overrides.env)


def create_handler_from_str(env_name: str) -> EnvHandler:
    if env_name.startswith("dmcontrol___"):
        return DmcontrolEnvHandler()
    if env_name in _MUJOCO_NAMES:
        return MujocoEnvHandler()
    if env_name.startswith("gym___") and any(tok in env_name for tok in _MUJOCO_GYM_TOKENS):
        return MujocoEnvHandler()
    return GenericEnvHandler()
