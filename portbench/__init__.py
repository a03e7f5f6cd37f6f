"""The benchmark of ``mbrl_tpu_torch`` on NVIDIA H100 cards (README.md)."""
