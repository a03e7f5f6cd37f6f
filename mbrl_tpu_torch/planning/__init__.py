"""Agents and trajectory optimizers."""
from mbrl_tpu_torch.planning.core import Agent, RandomAgent
from mbrl_tpu_torch.planning.trajectory_opt import (
    CEMOptimizer,
    Optimizer,
    TrajectoryOptimizer,
    TrajectoryOptimizerAgent,
    create_trajectory_optim_agent_for_model,
)

__all__ = [
    "Agent",
    "CEMOptimizer",
    "Optimizer",
    "RandomAgent",
    "TrajectoryOptimizer",
    "TrajectoryOptimizerAgent",
    "create_trajectory_optim_agent_for_model",
]
