"""The SAC policy kernel (``kernels.fused_policy_mlp``, ``csrc/policy_mlp.cu``).

On the CPU, without a card:

- its plain version, which repeats the kernel's 3xTF32 split and its head
  sum over 128-column tiles in order, against ``GaussianPolicy``'s
  ``nn.Linear`` forward at the Walker (17 -> 1,024 -> 12), Humanoid (45 ->
  1,024 -> 34) and HalfCheetah (17 -> 512 -> 12) widths, at ragged rows;
- the packed tiles read back at the addresses the kernel reads them from,
  and linear1's accumulators stored where the consumers' fragments read
  them, by an emulation of the kernel's tiles;
- the dispatch (grad, device, rows) and the pack cache, by the counters of
  ``kernels.launch_counts()``, the kernel's CUDA branch against a stand-in
  library.

On the card (``-m card``): the kernel against its plain version at 100,000
and 100,003 rows for the three widths and at the dispatch threshold's edge,
and the launches of an imagined rollout. This file imports no JAX, so the
card tests run with ``--noconftest``.
"""
import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mbrl_tpu_torch.algorithms.mbpo as mbpo
from mbrl_tpu_torch.envs.spaces import Box
from mbrl_tpu_torch.models import GaussianMLP, ModelEnv, TransitionRewardModel
from mbrl_tpu_torch.ops import build
from mbrl_tpu_torch.ops import kernels as tk
from mbrl_tpu_torch.planning.sac import SAC, GaussianPolicy
from mbrl_tpu_torch.util.device_buffer import DeviceReplayBuffer

WIDTHS = {"walker": (17, 1024, 6), "humanoid": (45, 1024, 17), "halfcheetah": (17, 512, 6)}


def _policy(din, hidden, act, seed=0, device="cpu"):
    """A policy with the port's initialisation and biases N(0, 0.1), so that
    every bias reaches the output."""
    torch.manual_seed(seed)
    p = GaussianPolicy(din, act, hidden).to(device)
    with torch.no_grad():
        for layer in p._layers():
            layer.bias.normal_(0.0, 0.1)
    return p


def _linear_forward(p, obs):
    """``GaussianPolicy.forward``'s ``nn.Linear`` route as it was written
    before the kernel."""
    x = F.relu(p.linear2(F.relu(p.linear1(obs))))
    return p.mean_linear(x), torch.clamp(p.log_std_linear(x), -20.0, 2.0)


def _tolerance(ref):
    # Both sides are within a few f32 roundings of the float64 forward (about
    # 2e-7 at these widths, measured): 3xTF32 leaves out a_lo b_lo, under
    # 2^-22 of each product, and rounds the operands' rest to 11 bits; the
    # f32 sums over 1,024 terms round as much. Ten times the measured gap.
    return 2e-6 * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("rows", [1, 257, 1000])
@pytest.mark.parametrize("name", list(WIDTHS))
def test_plain_version_matches_the_linear_forward(name, rows):
    p = _policy(*WIDTHS[name])
    x = torch.randn((rows, WIDTHS[name][0]), generator=torch.Generator().manual_seed(rows))
    with torch.no_grad():
        ref_mean, ref_log_std = _linear_forward(p, x)
        mean, log_std = tk.fused_policy_mlp_plain(x, p.packed())
    assert mean.shape == ref_mean.shape and log_std.shape == ref_log_std.shape
    torch.testing.assert_close(mean, ref_mean, rtol=0, atol=_tolerance(ref_mean))
    torch.testing.assert_close(log_std, ref_log_std, rtol=0, atol=_tolerance(ref_log_std))


def test_plain_version_clamps_log_std_and_sums_the_tiles_in_order():
    p = _policy(17, 256, 3)
    with torch.no_grad():
        p.log_std_linear.bias[:] = torch.tensor([30.0, -40.0, 0.0])
    x = torch.randn((64, 17), generator=torch.Generator().manual_seed(1))
    pack = p.packed()
    mean, log_std = tk.fused_policy_mlp_plain(x, pack)
    assert log_std[:, 0].eq(2.0).all() and log_std[:, 1].eq(-20.0).all()
    # the same sum written out: tile 0's partial heads, then tile 1's, then the bias
    w1_hi, w1_lo, w2_hi, w2_lo, wh_hi, wh_lo = tk.unpack_policy(pack)
    x_hi = tk.rna_tf32(x)
    x_lo = tk.rna_tf32(x - x_hi)
    h1 = F.relu(x_lo @ w1_hi + x_hi @ w1_lo + x_hi @ w1_hi + pack.b1)
    a_hi = tk.rna_tf32(h1)
    a_lo = tk.rna_tf32(h1 - a_hi)
    h2 = F.relu(a_lo @ w2_hi + a_hi @ w2_lo + a_hi @ w2_hi + pack.b2)
    parts = []
    for n in range(2):
        g = h2[:, 128 * n: 128 * (n + 1)]
        g_hi = tk.rna_tf32(g)
        g_lo = tk.rna_tf32(g - g_hi)
        rows = slice(128 * n, 128 * (n + 1))
        parts.append(g_lo @ wh_hi[rows] + g_hi @ wh_lo[rows] + g_hi @ wh_hi[rows])
    heads = (torch.zeros_like(parts[0]) + parts[0] + parts[1])[:, :6] + pack.bh
    assert torch.equal(mean, heads[:, :3])


@pytest.mark.parametrize("name", list(WIDTHS))
def test_pack_holds_the_weights_split_as_3xtf32(name):
    p = _policy(*WIDTHS[name])
    pack = p.packed()
    w1_hi, w1_lo, w2_hi, w2_lo, wh_hi, wh_lo = tk.unpack_policy(pack)
    w1t = p.linear1.weight.detach().t()
    assert torch.equal(w1_hi, tk.rna_tf32(w1t)) and torch.equal(w1_lo, tk.rna_tf32(w1t - w1_hi))
    w2t = p.linear2.weight.detach().t()
    assert torch.equal(w2_hi, tk.rna_tf32(w2t)) and torch.equal(w2_lo, tk.rna_tf32(w2t - w2_hi))
    act = WIDTHS[name][2]
    wh = torch.cat([p.mean_linear.weight, p.log_std_linear.weight]).detach().t()
    assert pack.head_pad % tk.POLICY_HEAD_STEP == 0 and pack.head_pad >= 2 * act
    assert torch.equal(wh_hi[:, :2 * act], tk.rna_tf32(wh))
    assert torch.equal(wh_lo[:, :2 * act], tk.rna_tf32(wh - wh_hi[:, :2 * act]))
    assert not wh_hi[:, 2 * act:].any() and not wh_lo[:, 2 * act:].any()
    # the hi copies are tf32: their 13 low bits are zero
    assert not (w2_hi.view(torch.int32) & 0x1FFF).any()


# --------------------------------------------------------------------------- #
# The kernel's addressing, emulated (csrc/policy_mlp.cu)
# --------------------------------------------------------------------------- #
def _fragment_rows_cols():
    """Where a consumer thread's A fragment comes from in its subtile and
    k-step (policy_fragment: 16 bytes at 512 warp + 16 lane): the (row, col)
    of each of the 2,048 bytes' 512 floats, as a0..a3 = (r, t), (r + 8, t),
    (r, t + 4), (r + 8, t + 4)."""
    warp, lane, u = np.meshgrid(np.arange(4), np.arange(32), np.arange(4), indexing="ij")
    r = 16 * warp + lane // 4 + 8 * (u % 2)
    c = lane % 4 + 4 * (u // 2)
    return r.ravel(), c.ravel()  # in the order of the floats


def _read_b(flat, start, lbo, k_rows, n_cols):
    """A K-major, unswizzled wgmma B operand of k_rows x n_cols at float
    offset ``start``: element (k, n) at (k / 4) lbo + (n / 8) 128 + (n % 8) 16
    + (k % 4) 4 bytes (lbo in bytes; the stride byte offset is 128)."""
    k, n = np.meshgrid(np.arange(k_rows), np.arange(n_cols), indexing="ij")
    byte = (k // 4) * lbo + (n // 8) * 128 + (n % 8) * 16 + (k % 4) * 4
    return flat[start + byte // 4]


def _emulate(x, pack):
    """policy_mlp_kernel's tiles, each operand read at the address the kernel
    reads it from (ring buffers filled as the producers of a cluster's two
    blocks copy them), in 3xTF32 (the sums in f32, as the kernel's flushes
    keep them); then policy_heads_kernel's ordered sum."""
    rows, hidden, act, nh = x.shape[0], pack.hidden, pack.act, pack.head_pad
    rows_pad = -(-rows // 256) * 256
    nc, nt, kp = hidden // tk.POLICY_CHUNK, pack.col_tiles, pack.in_pad
    fr, fc = _fragment_rows_cols()
    split = lambda v: (tk.rna_tf32(v), tk.rna_tf32(v - tk.rna_tf32(v)))  # noqa: E731
    # linear1: each column tile's W1 block from its tiles, each lane's
    # accumulators (r, 8j + 2t), (r + 8, 8j + 2t), (r, 8j + 2t + 1), (r + 8, 8j +
    # 2t + 1) stored with h1's biases of columns 8j + t and 8j + t + 4 as the
    # float4 of h1's fragment layout
    xp = torch.zeros((rows_pad, kp))
    xp[:rows, : pack.din] = x
    x_hi, x_lo = split(xp)
    h1f = torch.empty(rows_pad * hidden)
    m, sub, j, v, lane = np.meshgrid(np.arange(rows_pad // 256), np.arange(4), np.arange(16),
                                     np.arange(4), np.arange(32), indexing="ij")
    g, t = lane // 4, lane % 4
    r = 256 * m + 64 * sub + 16 * v + g
    for n in range(nt):
        w_hi = _read_b(pack.w1, n * 2 * kp * 128, 2048, kp, 128)
        w_lo = _read_b(pack.w1, n * 2 * kp * 128 + kp * 128, 2048, kp, 128)
        acc = x_lo @ w_hi + x_hi @ w_lo + x_hi @ w_hi
        kstep = n * 16 + j
        dst = ((((m * nc + kstep // 2) * 4 + sub) * 2 + kstep % 2) * 512 + 128 * v + 4 * lane).ravel()
        b_t, b_t4 = pack.b1[(128 * n + 8 * j + t).ravel()], pack.b1[(128 * n + 8 * j + t + 4).ravel()]
        for u, (dr, dc, bias) in enumerate([(0, 0, b_t), (8, 0, b_t), (0, 1, b_t4), (8, 1, b_t4)]):
            h1f[dst + u] = F.relu(acc[(r + dr).ravel(), (8 * j + 2 * t + dc).ravel()] + bias)
    part = torch.zeros((nt, rows_pad, 2 * act))
    head_floats = 2 * 64 * nh
    for m in range(rows_pad // 256):
        for n in range(nt):
            acc = torch.zeros((256, 128))
            for c in range(nc):
                # W2's chunk (hi, then lo), 16 KB, both halves multicast to both blocks
                b_buf = pack.w2[(n * nc + c) * 4096: (n * nc + c + 1) * 4096]
                for q in range(2):
                    b_hi = _read_b(b_buf, q * 2 * 2048 // 4, 2048, 8, 128)
                    b_lo = _read_b(b_buf, 2048 + q * 2 * 2048 // 4, 2048, 8, 128)
                    for rank in range(2):  # the block's 128 rows: 8 KB of h1's 16 KB chunk
                        at = (m * nc + c) * 4096 + rank * 2048
                        a_buf = h1f[at: at + 2048]
                        for wg in range(2):  # the warpgroup's 64 rows
                            a = torch.zeros((64, 8))
                            a[fr, fc] = a_buf[(wg * 2 + q) * 512: (wg * 2 + q + 1) * 512]
                            a_hi, a_lo = split(a)
                            span = slice(128 * rank + 64 * wg, 128 * rank + 64 * (wg + 1))
                            acc[span] += a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
            h2 = F.relu(acc + pack.b2[128 * n: 128 * (n + 1)])
            heads = torch.zeros((256, nh))
            for j in range(16):
                buf = pack.wh[(2 * n + j // 8) * head_floats: (2 * n + j // 8 + 1) * head_floats]
                lbo = nh * 16
                w_hi = _read_b(buf, (j % 8) * 2 * lbo // 4, lbo, 8, nh)
                w_lo = _read_b(buf, 64 * nh + (j % 8) * 2 * lbo // 4, lbo, 8, nh)
                # the fragment: k = t holds column 2t of the group, k = t + 4 column 2t + 1
                g_hi, g_lo = split(h2[:, 8 * j + np.array(tk.HEAD_ORDER)])
                heads += g_lo @ w_hi + g_hi @ w_lo + g_hi @ w_hi
            part[n, 256 * m: 256 * (m + 1)] = heads[:, :2 * act]
    total = torch.zeros((rows, 2 * act))
    for n in range(nt):
        total = total + part[n, :rows]
    total = total + pack.bh
    return total[:, :act], total[:, act:].clamp(-20.0, 2.0)


@pytest.mark.parametrize("din,hidden,act,rows", [(17, 256, 6, 300), (45, 128, 17, 257),
                                                  (5, 256, 32, 40)],
                         ids=["two_tiles", "humanoid_heads", "widest_heads"])
def test_emulated_kernel_matches_the_plain_version(din, hidden, act, rows):
    p = _policy(din, hidden, act, seed=rows)
    x = torch.randn((rows, din), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        pack = p.packed()
        mean, log_std = _emulate(x, pack)
        ref_mean, ref_log_std = tk.fused_policy_mlp_plain(x, pack)
    torch.testing.assert_close(mean, ref_mean, rtol=0, atol=_tolerance(ref_mean))
    torch.testing.assert_close(log_std, ref_log_std, rtol=0, atol=_tolerance(ref_log_std))


# --------------------------------------------------------------------------- #
# Dispatch, counters, the pack cache
# --------------------------------------------------------------------------- #
class _FakeLibrary:
    """Stands in for the built library: checks each call against its ctypes
    signature and records it."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        argtypes = build.SIGNATURES[name]

        def entry(*args):
            assert len(args) == len(argtypes), (name, len(args), len(argtypes))
            for t, a in zip(argtypes, args):
                t.from_param(a)
            self.calls.append((name, args))
            return 0

        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """The policy's kernel route on CPU tensors, against the stand-in library."""
    lib = _FakeLibrary()
    monkeypatch.setattr(tk, "_dispatch", lambda t: True)
    monkeypatch.setattr(tk, "on_card", lambda t: True)
    monkeypatch.setattr(tk, "_stream", lambda device: 0)
    monkeypatch.setattr(tk, "sm_count", lambda device: 132)
    monkeypatch.setattr(build, "load_library", lambda: lib)
    tk.reset_launch_counts()
    yield lib


def _counts():
    c = tk.launch_counts()
    return {k: c[k] for k in ("fused_policy_mlp", "fused_policy_mlp.repacks",
                              "fused_policy_mlp.linear")}


def test_the_threshold_is_one_wave_of_row_tiles():
    assert tk.POLICY_KERNEL_ROWS == 132 * tk.POLICY_ROWS == 33_792


def test_launch_counts_name_the_policy_kernel_apart_from_k3():
    tk.reset_launch_counts()
    counts = tk.launch_counts()
    assert {"fused_policy_mlp", "fused_policy_mlp.repacks", "fused_policy_mlp.linear"} <= set(counts)
    assert not any(k.startswith("fused_ensemble_mlp") and "policy" in k for k in counts)


def test_on_the_cpu_the_forward_takes_the_linear_route_and_the_wrapper_its_plain_version():
    p = _policy(17, 128, 6)
    x = torch.randn((tk.POLICY_KERNEL_ROWS, 17), generator=torch.Generator().manual_seed(0))
    tk.reset_launch_counts()
    with torch.no_grad():
        assert not p.takes_kernel(x)
        mean, _ = p(x)
    assert _counts() == {"fused_policy_mlp": 0, "fused_policy_mlp.repacks": 0,
                         "fused_policy_mlp.linear": 1}
    with torch.no_grad():
        ref_mean, _ = _linear_forward(p, x)
        assert torch.equal(mean, ref_mean)
        got, _ = tk.fused_policy_mlp(x[:100], p.packed())  # the plain version: no launch
    assert _counts() == {"fused_policy_mlp": 0, "fused_policy_mlp.repacks": 1,
                         "fused_policy_mlp.linear": 1}
    torch.testing.assert_close(got, ref_mean[:100], rtol=0, atol=_tolerance(ref_mean))


@pytest.mark.parametrize("case", ["kernel", "grad", "few_rows", "float64", "odd_width"])
def test_dispatch_by_grad_rows_and_widths(fake_card, case):
    din, hidden, act = (17, 200, 6) if case == "odd_width" else (17, 256, 6)
    p = _policy(din, hidden, act)
    rows = tk.POLICY_KERNEL_ROWS - 1 if case == "few_rows" else tk.POLICY_KERNEL_ROWS
    x = torch.zeros((rows, din), dtype=torch.float64 if case == "float64" else torch.float32)
    if case == "float64":
        p = p.double()
    with torch.set_grad_enabled(case == "grad"):
        mean, log_std = p(x)
    kernel = case == "kernel"
    assert _counts() == {"fused_policy_mlp": int(kernel), "fused_policy_mlp.repacks": int(kernel),
                         "fused_policy_mlp.linear": int(not kernel)}
    assert [c[0] for c in fake_card.calls] == (["mbrl_policy_mlp"] if kernel else [])
    assert mean.shape == log_std.shape == (rows, act)
    if kernel:  # rows, in, hidden, act, and a persistent grid of at most 132 blocks
        args = fake_card.calls[0][1]
        assert args[11:16] == (rows, din, hidden, act, 132)


def test_the_kernel_route_keeps_leading_dimensions(fake_card):
    p = _policy(17, 256, 6)
    with torch.no_grad():
        mean, log_std = p(torch.zeros((2, tk.POLICY_KERNEL_ROWS // 2, 17)))
    assert mean.shape == log_std.shape == (2, tk.POLICY_KERNEL_ROWS // 2, 6)
    assert fake_card.calls[0][1][11] == tk.POLICY_KERNEL_ROWS


def test_the_sac_update_keeps_its_route_and_its_gradients(fake_card):
    """The update differentiates the nn.Linear route, its no_grad next action
    at batch 256 too: gradients equal to the forward written before the
    kernel, and no launch."""
    p = _policy(17, 256, 6)
    obs = torch.randn((256, 17), generator=torch.Generator().manual_seed(5))
    mean, log_std = p(obs)
    grads = torch.autograd.grad((mean.square().sum() + log_std.sum()), list(p.parameters()))
    ref_mean, ref_log_std = _linear_forward(p, obs)
    ref = torch.autograd.grad((ref_mean.square().sum() + ref_log_std.sum()), list(p.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(grads, ref))
    with torch.no_grad():
        p(obs)
    assert _counts() == {"fused_policy_mlp": 0, "fused_policy_mlp.repacks": 0,
                         "fused_policy_mlp.linear": 2}
    assert fake_card.calls == []


def test_sac_updates_run_as_before():
    """Two SAC updates on the CPU: the same parameters as the same updates
    through the forward written before the kernel."""
    sac = SAC(17, Box(-np.ones(6), np.ones(6)), hidden_size=64, device="cpu")
    states = [sac.init(torch.Generator().manual_seed(0)) for _ in range(2)]
    rng = np.random.default_rng(0)
    batch = tuple(torch.as_tensor(b, dtype=torch.float32) for b in (
        rng.standard_normal((32, 17)), rng.uniform(-1, 1, (32, 6)), rng.standard_normal((32, 17)),
        rng.standard_normal((32, 1)), np.ones((32, 1))))
    old = GaussianPolicy.forward
    for k, state in enumerate(states):
        if k == 1:
            GaussianPolicy.forward = _linear_forward
        try:
            g = torch.Generator().manual_seed(1)
            for _ in range(2):
                sac.update_parameters(state, batch, g)
        finally:
            GaussianPolicy.forward = old
    for a, b in zip(states[0].policy.parameters(), states[1].policy.parameters()):
        assert torch.equal(a, b)


def test_the_pack_is_cached_until_a_step_or_a_load(fake_card):
    p = _policy(17, 256, 6)
    x = torch.zeros((tk.POLICY_KERNEL_ROWS, 17))
    with torch.no_grad():
        p(x)
        p(x)
    assert _counts()["fused_policy_mlp.repacks"] == 1 and _counts()["fused_policy_mlp"] == 2
    opt = torch.optim.Adam(p.parameters(), lr=1e-3)
    loss = sum(t.sum() for t in p(torch.ones((4, 17))))
    loss.backward()
    opt.step()
    with torch.no_grad():
        p(x)
    assert _counts()["fused_policy_mlp.repacks"] == 2
    p.load_state_dict(_policy(17, 256, 6, seed=9).state_dict())
    with torch.no_grad():
        p(x)
        p(x)
    assert _counts()["fused_policy_mlp.repacks"] == 3
    # a copy packs its own weights and carries no pack
    clone = copy.deepcopy(p)
    assert clone._pack is None and p._pack is not None
    with torch.no_grad():
        clone(x)
    assert _counts()["fused_policy_mlp.repacks"] == 4


def test_the_wrapper_refuses_what_the_kernel_does_not_take(fake_card):
    pack = _policy(17, 256, 6).packed()
    with pytest.raises(ValueError):
        tk.fused_policy_mlp(torch.zeros((300, 18)), pack)
    with pytest.raises(TypeError):
        tk.fused_policy_mlp(torch.zeros((300, 17), dtype=torch.float64), pack)
    with pytest.raises(ValueError):
        tk.pack_policy(*[t for layer in _policy(17, 200, 6)._layers()
                         for t in (layer.weight, layer.bias)])
    assert not tk.policy_supported(17, 1024, 33) and tk.policy_supported(17, 1024, 32)


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return "cuda"


def _card_check(p, rows, seed):
    """The kernel against its plain version (the same arithmetic, in another
    order of sums) and against the nn.Linear forward, on the card."""
    x = torch.randn((rows, p.linear1.in_features), generator=torch.Generator().manual_seed(seed))
    x = x.cuda()
    with torch.no_grad():
        pack = p.packed()
        mean, log_std = tk.fused_policy_mlp(x, pack)
        torch.cuda.synchronize()
        ref_mean, ref_log_std = tk.fused_policy_mlp_plain(x, pack)
        lin_mean, lin_log_std = _linear_forward(p, x)
    for got, ref, lin in ((mean, ref_mean, lin_mean), (log_std, ref_log_std, lin_log_std)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, ref, rtol=0, atol=_tolerance(ref))
        torch.testing.assert_close(got, lin, rtol=0, atol=_tolerance(lin))
    return float((mean - ref_mean).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("rows", [100_000, 100_003])
@pytest.mark.parametrize("name", list(WIDTHS))
def test_kernel_matches_its_plain_version_on_the_card(card, name, rows):
    p = _policy(*WIDTHS[name], device=card)
    tk.reset_launch_counts()
    _card_check(p, rows, seed=rows)
    assert tk.launch_counts()["fused_policy_mlp"] == 1


@pytest.mark.card
@pytest.mark.parametrize("name", list(WIDTHS))
def test_the_threshold_edge_on_the_card(card, name):
    p = _policy(*WIDTHS[name], device=card)
    _card_check(p, tk.POLICY_KERNEL_ROWS, seed=1)
    for rows, kernel in ((tk.POLICY_KERNEL_ROWS, True), (tk.POLICY_KERNEL_ROWS - 1, False)):
        x = torch.randn((rows, WIDTHS[name][0]), device=card)
        tk.reset_launch_counts()
        with torch.no_grad():
            mean, log_std = p(x)
            ref_mean, ref_log_std = _linear_forward(p, x)
        torch.cuda.synchronize()
        assert tk.launch_counts()["fused_policy_mlp"] == int(kernel)
        assert tk.launch_counts()["fused_policy_mlp.linear"] == int(not kernel)
        torch.testing.assert_close(mean, ref_mean, rtol=0, atol=_tolerance(ref_mean))
        torch.testing.assert_close(log_std, ref_log_std, rtol=0, atol=_tolerance(ref_log_std))


@pytest.mark.card
def test_an_imagined_rollout_launches_the_policy_kernel_and_packs_once(card):
    """Two imagined rollouts of 100,000 rows at length 3 with a 1,024-wide
    policy: every step's policy call on the kernel, one pack."""
    g = torch.Generator().manual_seed(0)
    obs_dim, act_dim, rows, horizon = 17, 6, 100_000, 3
    model = GaussianMLP(obs_dim + act_dim, obs_dim + 1, num_layers=4, ensemble_size=7,
                        hid_size=200, activation="silu", propagation_method="random_model",
                        device=card)
    wrapper = TransitionRewardModel(model, target_is_delta=True, normalize=True,
                                    normalize_double_precision=True, learned_rewards=True,
                                    num_elites=5)
    state = wrapper.set_elite(wrapper.init(g), list(range(5)))
    batch = type("Batch", (), {"obs": torch.randn((500, obs_dim), generator=g).to(card),
                               "act": torch.rand((500, act_dim), generator=g).to(card) * 2 - 1})
    state = wrapper.update_normalizer(state, batch)
    sac = SAC(obs_dim, Box(-np.ones(act_dim), np.ones(act_dim)), hidden_size=1024, device=card)
    policy = sac.init(torch.Generator(device=card).manual_seed(1)).policy
    env = ModelEnv(wrapper, lambda act, next_obs: torch.zeros((next_obs.shape[0], 1), dtype=torch.bool,
                                                               device=next_obs.device), None)
    buf = DeviceReplayBuffer(2 * rows * horizon, obs_dim, act_dim, device=card)
    buf_state = buf.init()
    tk.reset_launch_counts()
    for k in range(2):
        obs0 = torch.randn((rows, obs_dim), generator=g).to(card)
        buf_state = mbpo.imagined_rollout(env, state, sac, policy, buf, buf_state, obs0,
                                          torch.Generator(device=card).manual_seed(k), horizon,
                                          True)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert counts["fused_policy_mlp"] == 2 * horizon
    assert counts["fused_policy_mlp.repacks"] == 1 and counts["fused_policy_mlp.linear"] == 0
    assert counts["fused_ensemble_mlp"] == 2 * horizon
