"""Dynamics models, the model-as-environment and the model trainer."""
from mbrl_tpu_torch.models.gaussian_mlp import GaussianMLP
from mbrl_tpu_torch.models.model_env import ModelEnv
from mbrl_tpu_torch.models.trainer import DivergenceError, ModelTrainer
from mbrl_tpu_torch.models.transition_model import TransitionRewardModel

__all__ = ["DivergenceError", "GaussianMLP", "ModelEnv", "ModelTrainer", "TransitionRewardModel"]
