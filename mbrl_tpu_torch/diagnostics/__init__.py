"""Diagnostics of saved runs (counterpart of ``mbrl_tpu/diagnostics``).

Each tool computes on the device first (a method that returns numpy arrays),
then draws or writes; ``matplotlib``, ``imageio`` and ``pandas`` are imported
only inside the drawing, writing and reading functions.
"""
from .eval_model_on_dataset import DatasetEvaluator
from .finetune_model_with_controller import FineTuner
from .planet_visualizer import PlanetVisualizer
from .visualize_model_preds import Visualizer

__all__ = ["DatasetEvaluator", "FineTuner", "PlanetVisualizer", "Visualizer"]
