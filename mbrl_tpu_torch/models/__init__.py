"""Dynamics models, the model-as-environment and the model trainer."""
from mbrl_tpu_torch.models.base import PROPAGATION_METHODS, DynamicsModel, EnsembleModel
from mbrl_tpu_torch.models.basic_ensemble import BasicEnsemble
from mbrl_tpu_torch.models.conv_nets import Conv2dDecoder, Conv2dEncoder
from mbrl_tpu_torch.models.gaussian_mlp import GaussianMLP
from mbrl_tpu_torch.models.layers import ensemble_linear, ensemble_linear_init
from mbrl_tpu_torch.models.model_env import ModelEnv
from mbrl_tpu_torch.models.planet import PlaNetModel
from mbrl_tpu_torch.models.trainer import DivergenceError, ModelTrainer
from mbrl_tpu_torch.models.transition_model import TransitionRewardModel

__all__ = ["PROPAGATION_METHODS", "BasicEnsemble", "Conv2dDecoder", "Conv2dEncoder",
           "DivergenceError", "DynamicsModel", "EnsembleModel", "GaussianMLP", "ModelEnv",
           "ModelTrainer", "PlaNetModel", "TransitionRewardModel", "ensemble_linear",
           "ensemble_linear_init"]
