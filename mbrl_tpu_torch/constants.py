"""Shared logging format constants (counterpart of ``mbrl_tpu/constants.py``)."""

RESULTS_LOG_NAME = "results"

EVAL_LOG_FORMAT = [
    ("env_step", "S", "int"),
    ("episode_reward", "R", "float"),
]

STEP_LOG_FORMAT = [
    ("env_step", "S", "int"),
    ("reward", "R", "float"),
]
