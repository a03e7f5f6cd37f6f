"""The benchmark's yardstick: the card's published peaks, a kernel call's least
time (its roofline bound), the operations and bytes that a call or a rollout's
rows need, counted from shapes, and the share of a window in which the card
was busy.

``bound``, ``macs_per_row``, ``stack_bytes`` and ``profile_busy`` are frozen
copies of the repository's ``chip_smoke.py`` (lines 260, 268, 272 and 1182 when
they were copied), kept here so that no later change to that script moves the
yardstick. Nothing here imports the port.
"""
from __future__ import annotations

import time
from typing import Iterable, List, Sequence, Tuple

import torch

# published H100 SXM peaks (dense, at the 700 W limit): TF32 and bf16 tensor
# cores, HBM3 (chip_smoke.py:175)
PEAK_TF32, PEAK_BF16, PEAK_BYTES = 495e12, 989e12, 3.35e12


# chip_smoke.py:260
def bound(flops: float, nbytes: float, bf16: bool):
    """Least time on this card: bf16 products at the bf16 tensor peak; f32-grade
    products as 3xTF32, three tf32 products each, at the TF32 tensor peak."""
    t_ops = flops / PEAK_BF16 if bf16 else 3 * flops / PEAK_TF32
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# chip_smoke.py:268
def macs_per_row(dims) -> int:
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


# chip_smoke.py:272
def stack_bytes(stack) -> int:
    return stack.ws.numel() * stack.ws.element_size() + stack.bs.numel() * 4


def k3_flops_bytes(x_shape: Sequence[int], stack) -> Tuple[float, float]:
    """Operations and bytes of one K3 call on an (E, S, in) input: every row
    through its member's products; the input, the packed weights and biases
    and the output, each once (chip_smoke.py's ``check_k3``)."""
    e, rows, _ = x_shape
    flops = 2.0 * e * rows * macs_per_row(stack.dims)
    nbytes = stack_bytes(stack) + 4.0 * e * rows * (stack.dims[0] + stack.dims[-1])
    return flops, nbytes


def policy_dims(obs_dim: int, hidden: int, act_dim: int) -> List[int]:
    """The SAC policy's products: two hidden layers, then the mean and the
    log-std heads side by side."""
    return [obs_dim, hidden, hidden, 2 * act_dim]


def ensemble_dims(in_size: int, hid: int, num_layers: int, head_out: int) -> List[int]:
    return [in_size] + [hid] * num_layers + [head_out]


def rollout_flops_per_row(policy: Sequence[int], ensemble: Sequence[int]) -> float:
    """Operations of the products one imagined row needs: the policy's and its
    member's (2 per multiply-add)."""
    return 2.0 * (macs_per_row(policy) + macs_per_row(ensemble))


def busy_union(spans: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals (the merge in
    ``profile_busy``)."""
    busy, end = 0.0, -float("inf")
    for s, e in sorted(spans):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy


# chip_smoke.py:1182
def profile_busy(run, kernels=()):
    """``run()`` under ``torch.profiler``: the share of its wall time in which
    the card ran anything (union of device intervals), and the share in the
    kernels named. The profiler slows the host, so these wall times are not the
    times reported elsewhere."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise RuntimeError("the profiler saw no device activity")
    busy = busy_union((s, e) for s, e, _ in spans)
    ours = sum(e - s for s, e, n in spans if n.split("<")[0].split()[-1] in kernels)
    by_name = {}
    for s, e, n in spans:
        by_name[n[:48]] = by_name.get(n[:48], 0.0) + (e - s) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall_us / 1e3, "device_busy_share": busy / wall_us,
            "port_kernel_share": ours / wall_us, "device_ops": len(spans),
            "top_device_ms": dict(top)}
