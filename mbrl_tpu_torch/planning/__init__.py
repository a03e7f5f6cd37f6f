"""Agents and trajectory optimizers."""
from mbrl_tpu_torch.planning.closed_loop import ClosedLoopDriver
from mbrl_tpu_torch.planning.core import Agent, RandomAgent, load_agent
from mbrl_tpu_torch.planning.linear_feedback import PIDAgent
from mbrl_tpu_torch.planning.sac import SAC, SACAgent
from mbrl_tpu_torch.planning.trajectory_opt import (
    CEMOptimizer,
    ICEMOptimizer,
    MPPIOptimizer,
    Optimizer,
    TrajectoryOptimizer,
    TrajectoryOptimizerAgent,
    create_trajectory_optim_agent_for_model,
)

__all__ = [
    "Agent",
    "CEMOptimizer",
    "ClosedLoopDriver",
    "ICEMOptimizer",
    "MPPIOptimizer",
    "Optimizer",
    "PIDAgent",
    "RandomAgent",
    "SAC",
    "SACAgent",
    "TrajectoryOptimizer",
    "TrajectoryOptimizerAgent",
    "create_trajectory_optim_agent_for_model",
    "load_agent",
]
