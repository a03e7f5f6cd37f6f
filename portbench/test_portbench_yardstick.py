"""Operations, bytes and bounds against hand counts at both configurations'
widths, and the trace's reduction on made-up events."""
import types

import pytest
import torch

from portbench import tracing, yardstick as Y


def test_rollout_flops_per_row_by_hand():
    # HalfCheetah: policy 17x512 + 512x512 + 512x(2*6); member 23x200 + 3x200x200 + 200x36
    hc = Y.rollout_flops_per_row(Y.policy_dims(17, 512, 6), Y.ensemble_dims(23, 200, 4, 36))
    assert hc == 2 * ((8_704 + 262_144 + 6_144) + (4_600 + 120_000 + 7_200)) == 817_584
    # Walker2d: HalfCheetah's sizes with a 1,024-wide policy
    walker = Y.rollout_flops_per_row(Y.policy_dims(17, 1024, 6), Y.ensemble_dims(23, 200, 4, 36))
    assert walker == 2 * ((17_408 + 1_048_576 + 12_288) + 131_800) == 2_420_144
    # Humanoid: policy 45x1024 + 1024x1024 + 1024x34; member 62x200 + 3x200x200 + 200x92
    hum = Y.rollout_flops_per_row(Y.policy_dims(45, 1024, 17), Y.ensemble_dims(62, 200, 4, 92))
    assert hum == 2 * ((46_080 + 1_048_576 + 34_816) + (12_400 + 120_000 + 18_400)) == 2_560_544


@pytest.mark.parametrize("dims,rows,want_bytes,want_ms", [
    # HalfCheetah's K3 at 100,000 rows: weights 5 x 131,800 x 4 B, biases 5 x 836 x 4 B,
    # input 100,000 x 23 x 4 B, output 100,000 x 36 x 4 B; PERF.md's C100k bound 0.1598 ms
    ((23, 200, 200, 200, 200, 36), 20_000, 2_636_000 + 16_720 + 9_200_000 + 14_400_000,
     3 * 2 * 100_000 * 131_800 / 495e12 * 1e3),
    ((62, 200, 200, 200, 200, 92), 20_000,
     5 * 150_800 * 4 + 5 * 892 * 4 + 100_000 * 62 * 4 + 100_000 * 92 * 4,
     3 * 2 * 100_000 * 150_800 / 495e12 * 1e3),
])
def test_k3_bytes_and_bound_by_hand(dims, rows, want_bytes, want_ms):
    n_w = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    stack = types.SimpleNamespace(ws=torch.zeros(5, n_w), bs=torch.zeros(5, sum(dims[1:])),
                                  dims=dims, low_precision=False)
    flops, nbytes = Y.k3_flops_bytes((5, rows, dims[0]), stack)
    assert nbytes == want_bytes
    ms, by = Y.bound(flops, nbytes, False)
    assert by == "operations" and ms == pytest.approx(want_ms)
    if dims[0] == 23:
        assert round(ms, 4) == 0.1598


def test_busy_union():
    assert Y.busy_union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4


class _E:
    def __init__(self, kind, name, s, e, corr=0, tid=1, linked=0):
        self._v = (kind, name, s, e, corr, tid, linked)

    def activity_type(self):
        return self._v[0]

    def name(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


class _OldE(_E):
    """An event of a PyTorch whose raw events have no ``activity_type``."""

    activity_type = property()  # hasattr() is False

    def device_type(self):
        on = self._v[0] in ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")
        return torch.autograd.DeviceType.CUDA if on else torch.autograd.DeviceType.CPU


@pytest.mark.parametrize("event", [_E, _OldE], ids=["activity_type", "device_type"])
def test_reduce_attributes_device_time_to_spans_and_gaps_to_the_host(event):
    spans = types.SimpleNamespace(calls={"outer": 1, "inner": 2}, args={},
                                  names=["outer", "inner"])
    events = [
        event("user_annotation", tracing.WINDOW_SPAN, 0, 100),
        event("user_annotation", "outer", 1, 60),
        event("user_annotation", "inner", 2, 10),
        event("user_annotation", "inner", 20, 30, corr=30),
        event("gpu_user_annotation", "inner", 20, 40),
        event("cpu_op", "aten::add", 41, 42, corr=31),
        event("cuda_runtime", "cudaLaunchKernel", 3, 4, corr=7),
        event("cuda_runtime", "cudaLaunchKernel", 21, 22, corr=8),
        event("kernel", "k_a(int)", 10, 30, corr=7),
        event("kernel", "k_b", 30, 40, corr=8),
        # a launch the trace does not hold, linked to the host op around it
        event("kernel", "k_a(int)", 50, 80, corr=9, linked=31),
        event("kernel", "k_c", 90, 95, corr=99),
    ]
    t = tracing.reduce(events, 1e-7, spans)
    assert t.device_ops == 4 and t.unattributed_ops == 1
    assert t.busy_s == pytest.approx(65e-9)
    assert t.span_device_s["inner"] == pytest.approx(30e-9)
    assert t.span_device_s["outer"] == pytest.approx(60e-9)
    assert t.by_name["k_a"] == pytest.approx(50e-9)
    # gaps 0-10 (before any span), 40-50 (host in "outer"), 80-90 and 95-100
    assert t.idle_by_span == pytest.approx({"outer": 10e-9, "outside_spans": 25e-9})
    assert t.breakdown()["device_ops"][0][0] == "k_a"
