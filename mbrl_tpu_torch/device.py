"""Device resolution and explicit-generator sampling helpers.

Every random draw in the port takes an explicit ``torch.Generator`` (where the
JAX package takes a key). The port's generators are host (CPU) generators:
they drive small host-side draws (seed words, permutations, populations), whose
results are then moved to the compute device. The CUDA kernels draw their
Gaussian noise from an in-kernel counter-based Philox keyed on seed words drawn
here, so no device-side generator state is needed.

:func:`full_float32` pins float32 products to full precision for a block: on
an H100 cuDNN convolutions default to TF32.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Sequence, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``"cuda"``/``"cpu"`` (or a ``torch.device``) → ``torch.device``.

    Raises when CUDA is asked for but absent: the port never falls back to the
    CPU quietly.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


def rand(generator: torch.Generator, shape: Sequence[int], device: DeviceLike) -> torch.Tensor:
    """U[0, 1) float32 drawn from ``generator`` and placed on ``device``."""
    out = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return out.to(device)


def randn(generator: torch.Generator, shape: Sequence[int], device: DeviceLike) -> torch.Tensor:
    """Standard-normal float32 drawn from ``generator`` and placed on ``device``."""
    out = torch.randn(tuple(shape), generator=generator, device=generator.device)
    return out.to(device)


def randperm(generator: torch.Generator, n: int, device: DeviceLike) -> torch.Tensor:
    """Uniform permutation of ``range(n)`` (int64) on ``device``."""
    return torch.randperm(n, generator=generator, device=generator.device).to(device)


def randint(
    generator: torch.Generator, low: int, high: int, shape: Sequence[int], device: DeviceLike
) -> torch.Tensor:
    """Uniform int64 in ``[low, high)`` on ``device``."""
    out = torch.randint(low, high, tuple(shape), generator=generator, device=generator.device)
    return out.to(device)


def seed_words(generator: torch.Generator, n: int = 2) -> List[int]:
    """``n`` independent 32-bit seed words as Python ints in ``[0, 2**32)``."""
    words = torch.randint(0, 2**32, (n,), generator=generator, device=generator.device)
    return [int(w) for w in words.tolist()]


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """Float32 convolutions (cuDNN) and matmuls (cuBLAS) in full float32, not
    TF32, inside the block; the caller's settings come back after it, also on
    an exception. Process-wide flags: a backward pass that should be full
    float32 too runs inside the block."""
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    matmul = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(matmul)
