"""Dynamics models and the model-as-environment."""
from mbrl_tpu_torch.models.gaussian_mlp import GaussianMLP
from mbrl_tpu_torch.models.model_env import ModelEnv
from mbrl_tpu_torch.models.transition_model import TransitionRewardModel

__all__ = ["GaussianMLP", "ModelEnv", "TransitionRewardModel"]
