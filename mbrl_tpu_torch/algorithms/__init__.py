"""Model-based RL algorithms: PETS and MBPO."""
from . import mbpo, pets

__all__ = ["pets", "mbpo"]
