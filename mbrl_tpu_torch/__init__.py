"""PyTorch/CUDA port of ``mbrl_tpu`` for one NVIDIA H100.

The package mirrors ``mbrl_tpu``'s module paths and class names. It imports
``torch`` and never JAX or ``mbrl_tpu``. Entry points take a ``device`` that
defaults to ``"cuda"``; with no GPU present that default raises (see
:func:`mbrl_tpu_torch.device.resolve_device`). Pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels on the CPU.

Slice 1 covers PETS planning: ``TrajectoryOptimizerAgent`` with CEM →
``ModelEnv`` → shard-space fast rollout → ``GaussianMLP`` ensemble, with the
three rollout kernels hand-written in CUDA (``csrc/ensemble_mlp.cu``).
"""
from mbrl_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
