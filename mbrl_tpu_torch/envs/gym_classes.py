"""Classes whose instances are ``gymnasium`` objects, while the classes import
no ``gymnasium``.

The port's MuJoCo environments keep the JAX package's dotted names, and the
model side of two of them (``HalfCheetahEnv.preprocess_fn``,
``CartPoleEnv.preprocess_fn``) runs where ``gymnasium`` and ``mujoco`` are not
installed. So such a class is plain Python: it holds the static model-side
functions and the simulation methods. Making an instance builds, once, a
subclass that also derives from the ``gymnasium`` bases the class names
(``_gym_bases``), registers it in the class's module as ``_<name>Gym`` (where
pickle looks it up), and returns an instance of it: ``isinstance(env, HalfCheetahEnv)``
holds, and only making an instance imports ``gymnasium``.
"""
from __future__ import annotations

import sys
from typing import Tuple


class GymClass:
    """Base of the classes above; a subclass defines ``_gym_bases``."""

    @staticmethod
    def _gym_bases() -> Tuple[type, ...]:
        raise NotImplementedError

    def __new__(cls, *args, **kwargs):
        return object.__new__(_gym_subclass(cls))


def _gym_subclass(cls: type) -> type:
    if cls.__dict__.get("_is_gym_subclass", False):
        return cls
    name = f"_{cls.__name__}Gym"
    module = sys.modules[cls.__module__]
    sub = module.__dict__.get(name)
    if sub is None:
        sub = type(name, (cls,) + cls._gym_bases(),
                   {"__module__": cls.__module__, "__qualname__": name, "_is_gym_subclass": True})
        setattr(module, name, sub)
    return sub


def mujoco_bases() -> Tuple[type, ...]:
    """``gymnasium``'s MuJoCo environment and ``EzPickle``."""
    from gymnasium import utils
    from gymnasium.envs.mujoco import mujoco_env

    return mujoco_env.MujocoEnv, utils.EzPickle


def gym_asset(name: str) -> str:
    """A model file bundled with ``gymnasium``'s MuJoCo environments."""
    import os

    import gymnasium.envs.mujoco as m

    return os.path.join(os.path.dirname(m.__file__), "assets", name)


def box(low, high, shape, dtype):
    from gymnasium.spaces import Box

    return Box(low=low, high=high, shape=shape, dtype=dtype)
