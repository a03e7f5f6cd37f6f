"""Model-based RL algorithms."""
