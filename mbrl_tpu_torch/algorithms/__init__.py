"""Model-based RL algorithms: PETS, MBPO and PlaNet."""
from . import mbpo, pets, planet

__all__ = ["pets", "mbpo", "planet"]
