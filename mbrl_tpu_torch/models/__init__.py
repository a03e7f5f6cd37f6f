"""Dynamics models, the model-as-environment and the model trainer."""
from mbrl_tpu_torch.models.conv_nets import Conv2dDecoder, Conv2dEncoder
from mbrl_tpu_torch.models.gaussian_mlp import GaussianMLP
from mbrl_tpu_torch.models.model_env import ModelEnv
from mbrl_tpu_torch.models.planet import PlaNetModel
from mbrl_tpu_torch.models.trainer import DivergenceError, ModelTrainer
from mbrl_tpu_torch.models.transition_model import TransitionRewardModel

__all__ = ["Conv2dDecoder", "Conv2dEncoder", "DivergenceError", "GaussianMLP", "ModelEnv",
           "ModelTrainer", "PlaNetModel", "TransitionRewardModel"]
