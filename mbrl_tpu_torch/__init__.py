"""PyTorch/CUDA port of ``mbrl_tpu`` for one NVIDIA H100.

The package mirrors ``mbrl_tpu``'s module paths and class names. It imports
``torch`` and never JAX or ``mbrl_tpu``. Entry points take a ``device`` that
defaults to ``"cuda"``; with no GPU present that default raises (see
:func:`mbrl_tpu_torch.device.resolve_device`). Pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels on the CPU.

What is ported is the PETS loop: ``algorithms.pets.train`` collects with a
``TrajectoryOptimizerAgent`` (CEM, MPPI or iCEM) that plans through
``ModelEnv`` → shard-space fast rollout → ``GaussianMLP`` ensemble, on the three
rollout kernels hand-written in CUDA (``csrc/``), and refits the ensemble with
``ModelTrainer`` from a ``ReplayBuffer`` or its device mirror.
"""
from mbrl_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
