"""Environments, batched reward/termination functions and PETS env model hooks
(counterpart of ``mbrl_tpu/envs/__init__.py``).

``CartPoleEnv`` is the numpy continuous cartpole (``ENVIRONMENTS``). The MuJoCo
environments and the pixel wrapper (``MUJOCO_ENVS``) are resolved at first
use, as in the JAX package; their modules import no ``gymnasium`` (only making
an instance does), so the model-side functions of ``pets_halfcheetah`` and
``pets_cartpole`` run where ``gymnasium`` and ``mujoco`` are not installed.
"""
import importlib

from mbrl_tpu_torch.envs.cartpole_continuous import CartPoleEnv

ENVIRONMENTS = ("CartPoleEnv",)
# name: (module, class), as mbrl_tpu/envs/__init__.py:7-38 resolves them
_MUJOCO = {
    "PetsHalfCheetahEnv": ("pets_halfcheetah", "HalfCheetahEnv"),
    "PetsCartPoleEnv": ("pets_cartpole", "CartPoleEnv"),
    "AntTruncatedObsEnv": ("truncated_obs", "AntTruncatedObsEnv"),
    "HumanoidTruncatedObsEnv": ("truncated_obs", "HumanoidTruncatedObsEnv"),
    "PetsPusherEnv": ("pets_pusher", "PusherEnv"),
    "PetsReacher3DEnv": ("pets_reacher", "Reacher3DEnv"),
    "MujocoGymPixelWrapper": ("mujoco_pixel_wrapper", "MujocoGymPixelWrapper"),
}
MUJOCO_ENVS = tuple(_MUJOCO)

__all__ = ["CartPoleEnv", "ENVIRONMENTS", "MUJOCO_ENVS"]


def __getattr__(name):
    if name in _MUJOCO:
        module, cls = _MUJOCO[name]
        return getattr(importlib.import_module(f"{__name__}.{module}"), cls)
    raise AttributeError(name)
