"""Environments, batched reward/termination functions and PETS env model hooks
(counterpart of ``mbrl_tpu/envs/__init__.py``).

The package exports the environments the port has (``ENVIRONMENTS``). The
JAX package's lazily imported MuJoCo environments (``MUJOCO_ENVS``) are not
ported yet: asking for one raises ``NotImplementedError`` naming ``mujoco``.
"""
from mbrl_tpu_torch.envs.cartpole_continuous import CartPoleEnv

ENVIRONMENTS = ("CartPoleEnv",)
# mbrl_tpu/envs/__init__.py:7-38: imported there at first use, with mujoco
MUJOCO_ENVS = (
    "PetsHalfCheetahEnv", "PetsCartPoleEnv", "AntTruncatedObsEnv", "HumanoidTruncatedObsEnv",
    "PetsPusherEnv", "PetsReacher3DEnv", "MujocoGymPixelWrapper",
)

__all__ = ["CartPoleEnv", "ENVIRONMENTS", "MUJOCO_ENVS"]


def __getattr__(name):
    if name in MUJOCO_ENVS:
        raise NotImplementedError(
            f"{name} needs `mujoco` (and `gymnasium`), which the port does not use yet; its "
            "model-side functions are in mbrl_tpu_torch.envs"
        )
    raise AttributeError(name)
