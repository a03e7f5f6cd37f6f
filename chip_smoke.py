#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``mbrl_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase below
    python3 chip_smoke.py --published-e   # config E alone at its published 5,000 steps
    python3 chip_smoke.py --published-m   # config M alone at its published 5,000 steps
    python3 chip_smoke.py --policy        # the SAC policy kernel alone
    python3 chip_smoke.py --k3-head       # K3 with the Gaussian head alone

Builds the CUDA kernels from ``mbrl_tpu_torch/csrc/`` (one nvcc per source, all
at once): K1, K2 and K3 on the tensor-core chain (``tc_chain.cu``,
``ensemble_mlp.cu``) and on the wide route, on the tensor cores too (K1 and K2
in ``wide_tc.cu``; K3's ``ensemble_mlp_wide_smem_kernel`` in
``ensemble_mlp_wide_smem.cu`` up to 512 columns, ``ensemble_mlp_wide_tc_kernel``
in ``ensemble_mlp_wide.cu`` beyond). Holds each against its
plain PyTorch version at the main paths' shapes (f32 and bf16; K3 at 8,000
rows with a Gaussian and with a deterministic head, at 100,000 rows and at
config M's 80,000 on its two-tile route (at 100,000 and 100,005 rows also
reading its rows through a permutation and finishing the Gaussian head,
``--k3-head``), at one row a member on its cluster
route, and on each side of the routes' limits: 64 and 65 rows a member and
1,700, an odd 27 tiles a member; K2, mean path and samples, at the shapes of configs B and
E, of MPPI and of each of iCEM's populations; every activation at 200 and 300
columns; widths 256 to 1024 and a 12-product chain, K3 also past one wave at
264, 300 and 512; the wide route timed at 512 columns, K3 there at 8,000 and
100,000 rows, and at 1,024 columns) and times both, then drives
the port's entry points at full width (7-member GaussianMLP ensemble, 5
elites, 4x200 silu; CEM pop 400 x 20 particles x horizon 30, 5 iterations)
with random weights from a seed:

  A  the bench shape (learned rewards, rotate, bf16): whole-horizon kernel K1
  B  the PETS-HalfCheetah config (preprocess, analytic reward, sort, f32): K2
  C  ModelEnv.step (TS1): 5 steps on 8,000 particles, and a 20-step rollout of
     100,000 rows, the batch of MBPO-HalfCheetah's imagined rollouts, with
     uniform random actions (config M-HC runs the SAC policy at that batch):
     K3, with the weights packed once per rollout
  D  config B with a deterministic head: the per-step rollout on K3
  E  a whole PETS run, ``algorithms.pets.train`` on the port's continuous
     cartpole at the published ``pets_cartpole`` values (E=7, 5 elites, 4x200
     silu, f32; CEM 5 x 350 x 20 particles x horizon 15; 200 random steps,
     retraining every 50 steps on the device), ``num_steps`` cut to
     ``E_PLANNED_STEPS``: K2 at a 1,400-row shard, 5-wide input, real termination
  T  training alone at PETS-HalfCheetah's shape (in 24, out 18, batch 32,
     10,000 synthetic transitions): two epochs each of ``train_device`` and
     the host-iterator ``train``; loss and gradient on the card against the CPU
  MPPI (``pets_mppi_halfcheetah`` on B's model), iCEM (``pets_icem_cartpole``
  on E's trained model) and ``act_batch`` (4 environments, config B): K2
  W  a 512-wide model: two ``act``s of A (K1) and of B (K2), the first on a
     fresh agent, and ``GaussianMLP._forward_sharded`` (K3) against the CPU, all
     on the wide route; ``_forward_sharded`` of a 512-wide model with A's widths
     on C's 100,000 rows (past one wave) and of a 1,024-wide one on 8,000 rows
     (K3's scratch route), each against its plain version on the card; then a
     warm ``act`` of B under the profiler
  P  the propagation methods besides random_model, card against CPU:
     ``fixed_model`` with its persistent indices (K3) and on a batch the elites
     do not shard, ``expectation``, and the single-model ``gaussian_mlp.yaml``
     (the plain member forward)
  M  a whole MBPO run, ``algorithms.mbpo.train`` on the port's cartpole
     (``util.env.make_env``: TimeLimit 200) at the published ``mbpo_cartpole``
     values (E=7, 5 elites, 4x200 silu, f32, double normalizer; 5,000 steps of
     exploration by the SAC agent; 80,000 imagined rows a retraining, rollout
     length 1; SAC 256 wide, batch 256, 20 updates a step, target interval 4).
     The cuts: ``num_steps`` 5,000 -> ``M_NUM_STEPS`` (two epochs: 2
     retrainings, 2 evaluations, ~4,000 SAC updates), and
     ``algorithm.dataset_size`` set to 5,000 (the published ``num_steps``) so
     that the replay buffer keeps its published size. K3 at 80,000 rows, in 5.
     ``--published-m`` runs the published 5,000 steps instead (25 epochs)
  M-HC  MBPO-HalfCheetah's shape without the environment: a seeded model (in 23,
     out 18, 4x200) and SAC (512 wide, batch 256): imagined rollouts of
     100,000 rows (length 1, then 5), three bundles of 10 SAC updates, and
     one SAC update on the card against the CPU
  PN  a whole PlaNet run, ``algorithms.planet.train`` at ``dynamics_model/planet.yaml``'s
     full width (3x64x64 pixels, conv encoder to 1,024, belief 200, latent 30,
     hidden 200) with ``planet_cheetah_run``'s values (100 updates of 50
     windows of 50 steps an episode, CEM 1,000 x 12 x 10 in latent space, 5
     random trajectories of 250 steps), on a numpy stand-in for dm_control's
     cheetah-run (``PixelCheetah``). The cuts: ``num_episodes`` 1,000 -> 2
     (a test episode, then one with exploration noise) and ``dataset_size``
     1,000,000 -> 2,000. No K1-K3 launch; then the eval_score, the loss with
     fixed normals and its gradient on the card against the CPU, full float32
  CL  the closed-loop MPC driver (``planning.ClosedLoopDriver``), 20 steps each
     of CL-A (config A's model and planner: K1 once per CEM generation) and
     CL-B (config B's: K2 every planning step), both acting in the model they
     plan in (K3 at one row per elite every step); then its per-step times,
     the card's busy share of a run, the driver against a hand-written loop
     of ``optimize`` and ``ModelEnv.step`` from equal seeds, the agent's
     ``act`` at the same config, and CEM, iCEM and MPPI driving a toy
     integrator to its optimum
  BE  ``algorithms.pets.train`` with ``dynamics_model/basic_ensemble.yaml`` (5
     one-member GaussianMLPs of 4x200 silu, ``fixed_model``) on the port's
     cartpole at ``pets_cartpole``'s values, ``num_steps`` cut to
     ``BE_PLANNED_STEPS``: no K1-K3 launch; then the trained ensemble's forward,
     propagation, loss and gradient on the card against the CPU
  DG  the run directories of E, M and PN reloaded: ``load_experiment`` and
     ``load_agent`` on E's (the forward and the first action against the
     run's own model and a hand-built agent, to 0.0), a warm ``act`` timed
     and traced (``util.profiling``), ``DatasetEvaluator``'s prediction pass
     card against CPU, ``Visualizer`` and ``FineTuner`` with the run's
     planner; ``load_agent`` on M's (the SAC actions against the learner's,
     to 0.0) and an evaluation recorded by ``VideoRecorder``;
     ``PlanetVisualizer`` on PN's (its frames card against CPU); the
     true-dynamics controller (4 worker processes); the three tutorials
     (``tutorial_pets``: K2 at 4 elites of 3x128). The cuts: FineTuner's
     ``steps_to_collect`` 10,000 -> 200 and ``num_epochs`` 50 -> 5,
     ``tutorial_pets``' ``num_steps`` 2,000 -> 400, the 1-D fit's epochs
     500 -> 200
  POOL-E  config E's ``pets.train`` over a pool of 4 ``forkserver`` workers of
     the port's cartpole (``overrides.num_env_workers``): every batched step
     plans for each worker through ``act(batched=True)`` (K2 at E's shape, 75
     a plan). The cuts: ``num_steps`` 400 (100 batched steps) after E's
     exploration, ``trial_length`` 200 -> 100; no worker may initialise CUDA
  POOL-M  config M's ``mbpo.train`` over 4 workers: one ``SACAgent.act`` for
     the pool each batched step, K3 at 80,000 rows once a retraining. The
     cut: ``num_steps`` 400 (two epochs, 100 batched steps)
  MESH-1  ``parallel=mesh`` on the one card (a 1 x 1 mesh, no process group):
     E's retraining and first plan, an imagined rollout of M's 80,000 rows and
     a training epoch at M's width, one PlaNet update at ``planet.yaml``'s
     width, each equal (``torch.equal``) to the unsharded run, with equal
     launches
  MH  ``parallel.run_multihost_dryrun(2)``: two processes on this card under
     gloo (``psum=2``) take one training step at E's width with each member's
     256 rows split over the two ranks, held against the one-process step in
     full float32 (rtol 1e-5, atol 1e-6), and one ``train_device`` epoch
     (rtol 1e-4, atol 1e-5); they evaluate E's 350 x 20 particles 5 times on
     the fast path, each rank 75 K2 launches on its 175 sequences, the
     gathered returns equal on both ranks and in statistical agreement with
     one process's; and once on the generic path, 15 K3 launches a rank,
     equal to one process's (rtol 1e-5, atol 1e-6)

and checks that each config's launches went through its kernel, that the
rollout on the card agrees with the plain CPU path on an identical-member
model. Prints the card, a JSON line of per-kernel numbers and, last,
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device, and on
any failed check. Imports neither JAX nor the JAX package, and needs neither
``gymnasium`` nor ``pyyaml``.
"""
from __future__ import annotations

import copy
import functools
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
OBS_A, OBS_B, ACT = 17, 18, 6
POP, PARTICLES, HORIZON = 400, 20, 30
ENSEMBLE, ELITES, LAYERS, HID = 7, 5, 4, 200
BATCH = POP * PARTICLES
# MBPO HalfCheetah: effective_model_rollouts_per_step 400 x freq_train_model 250
# rows per imagined-rollout step (examples/conf/overrides/mbpo_halfcheetah.yaml)
MBPO_ROWS, MBPO_STEPS = 100_000, 20
# config E: planned steps of the PETS run (the published run has 5,000)
E_PLANNED_STEPS = 300
# config BE: planned steps of its PETS run (cut to make room for phase DG)
BE_PLANNED_STEPS = 100
OBS_E, ACT_E, POP_E = 4, 1, 350
MPPI_POP, ICEM_HORIZON = 350, 10
T_ROWS = 10_000
# the width sweep: two hidden layers of each width (256 is the chain's widest,
# the others take the wide route), then a chain of DEEP_PRODUCTS products;
# the wide route is timed at WIDE_HID columns
SWEEP_WIDTHS = (256, 264, 300, 512, 1024)
DEEP_PRODUCTS = 12
WIDE_HID = 512
# the sweep's K3 past one wave on its resident wide route: 2,017 rows a member
# (32 tiles, the last of one row; 160 tiles on 132 SMs) at these widths
SWEEP_PAST_WAVE, SWEEP_PAST_WAVE_ROWS = (264, 300, 512), 2_017
# the widest sweep width, which K3 runs on its scratch wide route
WIDEST_HID = 1024
# published H100 SXM peaks (dense): TF32 and bf16 tensor cores, HBM3
PEAK_TF32, PEAK_BF16, PEAK_BYTES = 495e12, 989e12, 3.35e12
# elementwise tolerances (|kernel - plain| <= atol + rtol * |plain|):
# f32 differs by summation order and, in K1/K2, by 3xTF32 products (the
# dropped lo*lo term and the tf32 rounding of lo, ~2^-22 relative) and the
# approximate silu (~2^-22); bf16 rounds at the same points in both, but an f32
# ulp can flip one bf16 rounding; K1 compounds both over 30 steps of the obs
# carry
TOL = {
    ("K3", "f32"): 1e-4, ("K2", "f32"): 1e-4, ("K1", "f32"): 1e-3,
    ("K3", "bf16"): 2e-2, ("K2", "bf16"): 2e-2, ("K1", "bf16"): 5e-2,
}
# each chain row's ms in PR 12's run of this script (H100 80GB HBM3, 700 W),
# before K3's chain was redesigned: (main-path dtype, other dtype)
PR12_MS = {
    "K1": (0.6328, 1.129), "K2": (0.03877, 0.02138), "K2@E": (0.03543, 0.01857),
    "K2@MPPI": (0.03889, 0.02100), "K2@iCEM": (0.03487, 0.01837), "K3": (0.03655, 0.02006),
    "K3@C100k": (0.4184, 0.2141), "K3@D": (0.03606, 0.01994), "K3@M": (0.3287, 0.1684),
    "K3@CL-A": (0.01883, 0.03511), "K3@CL-B": (0.03466, 0.01849), "K3@DG": (0.03343, 0.01827),
    "K2@TUT": (0.01992, 0.01200),
}
REPLACES = {
    "K1": "mbrl_tpu/ops/pallas_kernels.py:223 (fused_rollout_returns -> _rollout_kernel :141, pallas_call :299)",
    "K2": "mbrl_tpu/ops/pallas_kernels.py:381 (fused_ensemble_mlp_gaussian -> _gaussian_kernel :319, pallas_call :440)",
    "K3": "mbrl_tpu/ops/pallas_kernels.py:51 (fused_ensemble_mlp -> _kernel :34, pallas_call :101)",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def wrapper_launches() -> dict:
    """Each kernel wrapper's launches since the last reset: ``launch_counts``
    without K3's counts by route (its ``fused_ensemble_mlp.<route>`` keys)."""
    from mbrl_tpu_torch.ops import kernels as K

    return {w.__name__: w.launches for w in K.KERNEL_WRAPPERS}


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, iters: int) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed between two CUDA events, so the wrappers' host time is left out
    (``time_ms`` keeps it in)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, bf16: bool):
    """Least time on this card: bf16 products at the bf16 tensor peak; f32-grade
    products as 3xTF32, three tf32 products each, at the TF32 tensor peak."""
    t_ops = flops / PEAK_BF16 if bf16 else 3 * flops / PEAK_TF32
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def macs_per_row(dims) -> int:
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def stack_bytes(stack) -> int:
    return stack.ws.numel() * stack.ws.element_size() + stack.bs.numel() * 4


def elite_stack(in_size: int, out_size: int, dtype, g: torch.Generator,
                deterministic: bool = False, hid: int = HID, layers: int = LAYERS,
                members: int = ENSEMBLE, elites: int = ELITES):
    """An ``elites``-member packed stack (of ``members``) from the port's own
    init, and the logvar bounds (None for a deterministic model)."""
    from mbrl_tpu_torch.models import GaussianMLP

    model = GaussianMLP(in_size, out_size, layers, members, hid, activation="silu",
                        deterministic=deterministic, compute_dtype=dtype, device="cuda")
    params = model.set_elite(model.init(g), list(range(elites)))
    p = model._elite_view(params)
    if deterministic:
        return model.pack(p), None, None
    return model.pack(p), p["max_logvar"].contiguous(), p["min_logvar"].contiguous()


def check_k3(K, x, stack, dt_name: str, what: str):
    """K3 against its plain version on ``x``; its times and bound."""
    tiles = K.pack_tiles(stack)  # the layout of its route, packed once as a rollout does
    got = K.fused_ensemble_mlp(x, stack, tiles=tiles)
    ref = K.fused_ensemble_mlp_plain(x, stack)
    tol = TOL[("K3", dt_name)]
    err, ok = max_err(got, ref, tol)
    check(ok, f"K3 {dt_name} {what} disagrees with its plain version: max abs err {err}")
    e, rows, _ = x.shape
    flops = 2.0 * e * rows * macs_per_row(stack.dims)
    nbytes = stack_bytes(stack) + x.numel() * 4 + got.numel() * 4
    bms, bby = bound(flops, nbytes, stack.low_precision)
    sms = K.sm_count(x.device)
    if isinstance(tiles.layout, K.WideTileLayout):
        route = "wide/smem" if tiles.layout.k3_resident else "wide/scratch"
        blocks = K.persistent_blocks(rows, e, sms)
    else:
        route = K.k3_route(rows, e, sms, stack.low_precision)
        blocks = K.k3_blocks(route, rows, e, sms)
    return {
        "max_abs_err": err, "tol": tol, "rows": e * rows, "route": route, "blocks": blocks,
        "ms": time_graph_ms(lambda: K.fused_ensemble_mlp(x, stack, tiles=tiles), 20),
        "eager_ms": time_ms(lambda: K.fused_ensemble_mlp(x, stack, tiles=tiles), 20),
        "plain_ms": time_ms(lambda: K.fused_ensemble_mlp_plain(x, stack), 10),
        "bound_ms": bms, "bound_by": bby,
    }


def normal_moments(z: torch.Tensor, what: str):
    """Mean, variance and kurtosis of ``z``, which must be N(0, 1): each
    within five standard errors (the kurtosis' sqrt(24 / n), at least 0.1)."""
    z = z.double().flatten()
    n = z.numel()
    zm, zv = float(z.mean()), float(z.var())
    zk = float(((z - zm) ** 4).mean() / zv**2)
    check(abs(zm) < 5 / n**0.5 and abs(zv - 1) < 5 * (2 / n) ** 0.5
          and abs(zk - 3) < max(0.1, 5 * (24 / n) ** 0.5),
          f"{what} samples are not N(0,1): mean {zm} var {zv} kurtosis {zk}")
    return zm, zv, zk


def check_k2(K, g, x, stack, max_lv, min_lv, dt_name: str, what: str, **kw):
    """K2 on ``x``: its mean path against its plain version, its samples
    against N(0,1), and its times and bound; ``kw`` goes to the wrapper (a
    wide route's ``cluster``)."""
    out = stack.dims[-1] // 2
    tol = TOL[("K2", dt_name)]
    # the layout of its route, packed once as the rollout does
    tiles = K.pack_tiles(stack)
    got = K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, out, sample=False, tiles=tiles,
                                        **kw)
    ref = K.fused_ensemble_mlp_gaussian_plain(g, x, stack, max_lv, min_lv, out, sample=False)
    err, ok = max_err(got, ref, tol)
    check(ok, f"K2 {dt_name} ({what}, mean) disagrees with its plain version: max abs err {err}")
    # sampled path: z = (draw - mean) / sigma must be standard normal
    raw = K.fused_ensemble_mlp_plain(x, stack)
    sigma = torch.exp(0.5 * K.bound_logvar(raw[..., out:], max_lv, min_lv))
    draws = K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, out, sample=True, tiles=tiles,
                                          **kw)
    zm, zv, zk = normal_moments((draws - ref) / sigma, f"K2 {dt_name} ({what})")
    e, rows, _ = x.shape
    flops = 2.0 * e * rows * macs_per_row(stack.dims)
    nbytes = stack_bytes(stack) + x.numel() * 4 + got.numel() * 4 + 2 * out * 4
    bms, bby = bound(flops, nbytes, stack.low_precision)

    def launch():
        return K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, out, tiles=tiles, **kw)

    return {
        "max_abs_err": err, "tol": tol, "rows": e * rows, "z_mean": zm, "z_var": zv,
        "z_kurtosis": zk, "ms": time_graph_ms(launch, 20), "eager_ms": time_ms(launch, 20),
        "plain_ms": time_ms(
            lambda: K.fused_ensemble_mlp_gaussian_plain(g, x, stack, max_lv, min_lv, out), 10),
        "bound_ms": bms, "bound_by": bby,
    }


def check_k1(K, g, stack, max_lv, min_lv, dt_name: str, what: str, **kw):
    """K1 at config A's shape (B=8000, H=30, obs 17, act 6, tile 64): its mean
    path against its plain version, its sampled returns against the plain
    version's within standard error, and its times and bound; ``kw`` goes to
    the wrapper (a wide route's ``cluster``)."""
    dev = torch.device("cuda")
    shard = BATCH // ELITES
    tile = K.pick_tile(shard)
    num_tiles = BATCH // tile
    rot = torch.randint(0, num_tiles, (HORIZON,), generator=g)
    rot[0] = 0
    rot = (torch.cumsum(rot, 0) % num_tiles).to(dev, torch.int32)
    obs0 = (0.1 * torch.randn((OBS_A,), generator=g)).expand(BATCH, OBS_A).contiguous().to(dev)
    seqs = torch.rand((POP, HORIZON, ACT), generator=g) * 2 - 1
    acts = seqs.repeat(PARTICLES, 1, 1).contiguous().to(dev)
    dmask = torch.ones((1, OBS_A), device=dev)
    args = (rot, obs0, acts, dmask, stack, max_lv, min_lv, OBS_A + 1, tile)
    tiles = K.pack_tiles(stack, K.k1_extra_bytes(OBS_A, OBS_A + 1))
    got = K.fused_rollout_returns(g, *args, sample=False, tiles=tiles, **kw)
    ref = K.fused_rollout_returns_plain(g, *args, sample=False)
    err, ok = max_err(got, ref, TOL[("K1", dt_name)])
    check(ok, f"K1 {dt_name} {what} (mean path) disagrees with its plain version: max abs err {err}")
    # sampled path: per-sequence mean returns agree within standard error
    n_seeds = 8

    def per_seq(fn):
        runs = torch.stack([fn(g, *args, sample=True).reshape(PARTICLES, POP) for _ in range(n_seeds)])
        runs = runs.reshape(-1, POP).double()
        return runs.mean(0), runs.var(0), runs.shape[0]

    mk, vk, nk = per_seq(functools.partial(K.fused_rollout_returns, tiles=tiles, **kw))
    mp, vp, _ = per_seq(K.fused_rollout_returns_plain)
    se = torch.sqrt((vk + vp) / nk)
    z_max = float(((mk - mp).abs() / se).max())
    var_ratio = float(vk.mean() / vp.mean())
    check(z_max < 5.0 and 0.8 < var_ratio < 1.25,
          f"K1 {dt_name} {what} sampled returns differ: max |dmean|/se {z_max}, var ratio {var_ratio}")
    flops = 2.0 * BATCH * HORIZON * macs_per_row(stack.dims)
    nbytes = stack_bytes(stack) + (obs0.numel() + acts.numel() + got.numel()) * 4
    bms, bby = bound(flops, nbytes, stack.low_precision)
    return {
        "max_abs_err": err, "tol": TOL[("K1", dt_name)], "sampled_max_z": z_max,
        "sampled_var_ratio": var_ratio,
        "ms": time_graph_ms(lambda: K.fused_rollout_returns(g, *args, tiles=tiles, **kw), 5),
        "eager_ms": time_ms(lambda: K.fused_rollout_returns(g, *args, tiles=tiles, **kw), 5,
                            warmup=1),
        "plain_ms": time_ms(lambda: K.fused_rollout_returns_plain(g, *args), 3, warmup=1),
        "bound_ms": bms, "bound_by": bby,
    }


def icem_optimizer(device: str, population: int = 200, horizon: int = ICEM_HORIZON):
    """iCEM at overrides/pets_icem_cartpole.yaml's values (5 iterations, 200
    candidates decaying by 1.3, elite ratio 0.1, keep 0.3, colored noise 2,
    horizon 10, sizes rounded to the 7 members)."""
    from mbrl_tpu_torch.planning import ICEMOptimizer

    lb, ub = -np.ones((horizon, ACT_E), np.float32), np.ones((horizon, ACT_E), np.float32)
    return ICEMOptimizer(5, 0.1, population, population_decay_factor=1.3, colored_noise_exponent=2,
                         lower_bound=lb, upper_bound=ub, keep_elite_frac=0.3, alpha=0.1,
                         return_mean_elites=True, population_size_module=ENSEMBLE, device=device)


def icem_evaluated(icem) -> list:
    """Candidates iCEM scores in each iteration: the decayed population plus
    the elites kept from the one before, and the mean at the last."""
    sizes = icem.decay_population_sizes
    return [n + icem.keep_elite_size for n in sizes[:-1]] + [sizes[-1] + 1]


def icem_rows_per_member(icem) -> list:
    return [n * PARTICLES // ELITES for n in icem_evaluated(icem)]


def max_err(got: torch.Tensor, ref: torch.Tensor, tol: float):
    err = (got - ref).abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol + tol * ref.abs()).all())
    return float(err.max()), ok


# --------------------------------------------------------------------------- #
# Phase 2: each kernel against its plain version, at main-path shapes
# --------------------------------------------------------------------------- #
def kernel_checks():
    from mbrl_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda")
    results = {}
    shard = BATCH // ELITES
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        # K3 / K2 at config B/C shapes: E=5, S=1600, in=24, out=18
        stack, max_lv, min_lv = elite_stack(OBS_B + ACT, OBS_B, dtype, g)
        x = torch.randn((ELITES, shard, OBS_B + ACT), generator=g).to(dev)

        results[("K3", dt_name)] = check_k3(K, x, stack, dt_name, "C8k")
        # K3 at config CL-B's act-env step: one row per elite
        results[("K3@CL-B", dt_name)] = check_k3(K, x[:, :1].contiguous(), stack, dt_name, "CL-B")
        # K3 at config D's shape: the same rows into a deterministic head (18 columns)
        det, _, _ = elite_stack(OBS_B + ACT, OBS_B, dtype, g, deterministic=True)
        results[("K3@D", dt_name)] = check_k3(K, x, det, dt_name, "D")
        # K3 on each side of its routes' limits: S = 64 (one tile a block) and
        # 65 (two tiles a member), and 1,700 rows (27 tiles a member, an odd
        # count: 135 tiles, past one wave, on the two-tile route)
        for name, n in (("S64", 64), ("S65", 65), ("x1700", 1_700)):
            xs = torch.randn((ELITES, n, OBS_B + ACT), generator=g).to(dev)
            results[(f"K3@{name}", dt_name)] = check_k3(K, xs, stack, dt_name, name)

        results[("K2", dt_name)] = check_k2(K, g, x, stack, max_lv, min_lv, dt_name, "B")
        # MPPI's population on the same model: 350 x 20 / 5 = 1,400 rows
        results[("K2@MPPI", dt_name)] = check_k2(K, g, x[:, :MPPI_POP * PARTICLES // ELITES].contiguous(),
                                                 stack, max_lv, min_lv, dt_name, "MPPI")

        # K2 at config E's shape (cartpole): E=5, S=350*20/5=1,400 rows (not a
        # multiple of the 64-row tile), in 5, out 4; and at each row count of
        # iCEM's decayed populations on the same model
        stack_e, max_e, min_e = elite_stack(OBS_E + ACT_E, OBS_E, dtype, g)
        xe = torch.randn((ELITES, POP_E * PARTICLES // ELITES, OBS_E + ACT_E), generator=g).to(dev)
        results[("K2@E", dt_name)] = check_k2(K, g, xe, stack_e, max_e, min_e, dt_name, "E")
        # K3 at config DG's model rollouts on E's model (Visualizer's 5
        # samples): one row per elite
        results[("K3@DG", dt_name)] = check_k3(K, xe[:, :1].contiguous(), stack_e, dt_name, "DG")
        # K2 at tutorial_pets' shape: 4 elites of 3x128, 350 x 20 / 4 = 1,750 rows
        stack_t, max_t, min_t = elite_stack(OBS_E + ACT_E, OBS_E, dtype, g, hid=TUT_HID,
                                            layers=TUT_LAYERS, members=TUT_MEMBERS,
                                            elites=TUT_ELITES)
        xt = torch.randn((TUT_ELITES, POP_E * PARTICLES // TUT_ELITES, OBS_E + ACT_E),
                         generator=g).to(dev)
        results[("K2@TUT", dt_name)] = check_k2(K, g, xt, stack_t, max_t, min_t, dt_name,
                                                "tutorial_pets")
        # one iCEM plan launches K2 `horizon` times at each of these row counts:
        # the row of the kernels' line is the mean over them, the worst error
        per_rows = {}
        for rows_e in icem_rows_per_member(icem_optimizer("cuda")):
            xe = torch.randn((ELITES, rows_e, OBS_E + ACT_E), generator=g).to(dev)
            per_rows[rows_e] = check_k2(K, g, xe, stack_e, max_e, min_e, dt_name, f"iCEM, {rows_e} rows")
        runs = list(per_rows.values())
        results[("K2@iCEM", dt_name)] = {
            "max_abs_err": max(r["max_abs_err"] for r in runs), "tol": runs[0]["tol"],
            **{k: float(np.mean([r[k] for r in runs])) for k in ("ms", "eager_ms", "plain_ms", "bound_ms")},
            "bound_by": runs[0]["bound_by"],
            "rows_per_member": {n: {k: r[k] for k in ("max_abs_err", "ms", "bound_ms", "z_kurtosis")}
                                for n, r in per_rows.items()},
        }

        # K1 at config A's shape: B=8000, H=30, obs 17, act 6, tile 64
        stack, max_lv, min_lv = elite_stack(OBS_A + ACT, OBS_A + 1, dtype, g)
        # K3 at the MBPO rollout's shape: E=5 x S=20,000, in 23, head 36 (many waves)
        x = torch.randn((ELITES, MBPO_ROWS // ELITES, OBS_A + ACT), generator=g).to(dev)
        results[("K3@C100k", dt_name)] = check_k3(K, x, stack, dt_name, "C100k")
        del x
        # K3 at config CL-A's act-env step: one row per elite of A's model
        x = torch.randn((ELITES, 1, OBS_A + ACT), generator=g).to(dev)
        results[("K3@CL-A", dt_name)] = check_k3(K, x, stack, dt_name, "CL-A")
        results[("K1", dt_name)] = check_k1(K, g, stack, max_lv, min_lv, dt_name, "A")
        print(f"kernels {dt_name}: " + json.dumps(
            {k[0]: results[k] for k in results if k[1] == dt_name}), flush=True)
    return results


def activation_sweep():
    """K3 and K2 (mean path) for every activation, on a ragged row count
    (100 rows: one full 64-row tile and one partial), f32 and bf16; K3 also on
    a deterministic model's head (18 columns, not 36). At ``HID`` columns (the
    chain) and at 300 (the wide route)."""
    from mbrl_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(SEED + 9)
    dev = torch.device("cuda")
    errs = {}
    for hid in (HID, 300):
        dims = (OBS_B + ACT, hid, hid, 2 * OBS_B)
        ws = [0.1 * torch.randn((ELITES, a, b), generator=g) for a, b in zip(dims[:-1], dims[1:])]
        bs = [0.1 * torch.randn((ELITES, 1, b), generator=g) for b in dims[1:]]
        x = torch.randn((ELITES, 100, dims[0]), generator=g).to(dev)
        max_lv = torch.full((1, OBS_B), 0.5, device=dev)
        min_lv = torch.full((1, OBS_B), -10.0, device=dev)
        for act in K.ACTIVATION_CODES:
            for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                stack = K.pack_mlp([w.to(dev) for w in ws[:-1]], [b.to(dev) for b in bs[:-1]],
                                   ws[-1].to(dev), bs[-1].to(dev), act, dtype=dtype)
                tol = TOL[("K3", dt_name)]
                e3, ok3 = max_err(K.fused_ensemble_mlp(x, stack),
                                  K.fused_ensemble_mlp_plain(x, stack), tol)
                e2, ok2 = max_err(
                    K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, OBS_B, sample=False),
                    K.fused_ensemble_mlp_gaussian_plain(g, x, stack, max_lv, min_lv, OBS_B,
                                                        sample=False),
                    tol)
                det = K.pack_mlp([w.to(dev) for w in ws[:-1]], [b.to(dev) for b in bs[:-1]],
                                 ws[-1][..., :OBS_B].contiguous().to(dev),
                                 bs[-1][..., :OBS_B].contiguous().to(dev), act, dtype=dtype)
                ed, okd = max_err(K.fused_ensemble_mlp(x, det), K.fused_ensemble_mlp_plain(x, det),
                                  tol)
                check(ok3 and ok2 and okd, f"{act} {dt_name} at {hid} columns: kernel vs plain "
                                           f"max abs err K3 {e3}, K2 {e2}, K3 deterministic head {ed}")
                errs[f"{act}/{dt_name}/{hid}"] = max(e3, e2, ed)
    return errs


def width_sweep(device: str = "cuda"):
    """K3, K2 and K1 (mean paths) against their plain versions at each width
    of ``SWEEP_WIDTHS`` (two hidden layers: 256 is the chain's widest, the
    others take the wide route) and through a ``DEEP_PRODUCTS``-product chain
    64 wide (the wide route), f32 and bf16: K3 and K2 on ragged rows (100 a
    member), K3 also past one wave (``SWEEP_PAST_WAVE_ROWS`` a member) at
    ``SWEEP_PAST_WAVE``, K1 over 3 steps of 640 rows. Checks the route each
    took (K3's wide one: resident up to 512 columns, 1,024 on the scratch), and the
    samples: K2's draws about its mean must be N(0, 1), and K1's sampled
    returns must agree with the plain version's within standard error, row
    by row over 16 launches each."""
    from mbrl_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(SEED + 10)
    dev = torch.device(device)
    errs, samples = {}, {}
    launches = 16
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for width in SWEEP_WIDTHS + ("deep",):
            hidden = (64,) * (DEEP_PRODUCTS - 1) if width == "deep" else (width, width)
            for name, in_size, out in (("K3", OBS_B + ACT, OBS_B), ("K2", OBS_B + ACT, OBS_B),
                                       ("K1", OBS_A + ACT, OBS_A + 1)):
                dims = (in_size, *hidden, 2 * out)
                ws = [(torch.randn((ELITES, a, b), generator=g) / a**0.5).to(dev)
                      for a, b in zip(dims[:-1], dims[1:])]
                bs = [(0.1 * torch.randn((ELITES, 1, b), generator=g)).to(dev) for b in dims[1:]]
                stack = K.pack_mlp(ws[:-1], bs[:-1], ws[-1], bs[-1], "silu", dtype=dtype)
                max_lv = torch.full((1, out), 0.5, device=dev)
                min_lv = torch.full((1, out), -10.0, device=dev)
                extra = (K.k1_extra_bytes(OBS_A, out) if name == "K1"
                         else K.k2_extra_bytes(out) if name == "K2" else 0)
                chain = K.takes_chain(dims, dtype == torch.bfloat16, extra)
                check(chain == (width == K.TC_MAX_WIDTH),
                      f"{name} at width {width}: took the {'chain' if chain else 'wide route'}")
                if name == "K1":
                    batch, steps = ELITES * 2 * K.MAX_TILE, 3
                    rot = torch.tensor([0, 3, 7], dtype=torch.int32, device=dev)
                    obs0 = (0.1 * torch.randn((batch, OBS_A), generator=g)).to(dev)
                    acts = (torch.rand((batch, steps, ACT), generator=g) * 2 - 1).to(dev)
                    args = (rot, obs0, acts, torch.ones((1, OBS_A), device=dev), stack, max_lv,
                            min_lv, out, K.MAX_TILE)
                    got = K.fused_rollout_returns(g, *args, sample=False)
                    ref = K.fused_rollout_returns_plain(g, *args, sample=False)
                else:
                    x = torch.randn((ELITES, 100, in_size), generator=g).to(dev)
                    if name == "K2":
                        got = K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, out,
                                                            sample=False)
                        ref = K.fused_ensemble_mlp_gaussian_plain(g, x, stack, max_lv, min_lv,
                                                                  out, sample=False)
                    else:
                        got = K.fused_ensemble_mlp(x, stack)
                        ref = K.fused_ensemble_mlp_plain(x, stack)
                        if not chain:  # K3's wide route by shape: resident up to 512 columns
                            resident = K.WideTileLayout(dims, dtype == torch.bfloat16).k3_resident
                            check(resident == (width != 1024),
                                  f"K3 {dt_name} at width {width}: resident route {resident}")
                        if width in SWEEP_PAST_WAVE:
                            # past one wave, a ragged last tile of one row a member
                            xs = torch.randn((ELITES, SWEEP_PAST_WAVE_ROWS, in_size), generator=g).to(dev)
                            err, ok = max_err(K.fused_ensemble_mlp(xs, stack),
                                              K.fused_ensemble_mlp_plain(xs, stack), TOL[(name, dt_name)])
                            check(ok, f"K3 {dt_name} at width {width}, {SWEEP_PAST_WAVE_ROWS} rows a "
                                      f"member: max abs err {err}")
                            errs[f"K3/{dt_name}/{width}/{SWEEP_PAST_WAVE_ROWS}"] = err
                what = f"{name} {dt_name} at width {width} ({len(dims) - 1} products)"
                err, ok = max_err(got, ref, TOL[(name, dt_name)])
                check(ok, f"{what} disagrees with its plain version: max abs err {err}")
                errs[f"{name}/{dt_name}/{width}"] = err
                if name == "K2":
                    raw = K.fused_ensemble_mlp_plain(x, stack)
                    sigma = torch.exp(0.5 * K.bound_logvar(raw[..., out:], max_lv, min_lv))
                    draws = K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, out)
                    samples[f"K2/{dt_name}/{width}"] = normal_moments((draws - got) / sigma, what)
                elif name == "K1":
                    def runs(fn):
                        r = torch.stack([fn(g, *args) for _ in range(launches)]).double()
                        return r.mean(0), r.var(0)

                    mk, vk = runs(K.fused_rollout_returns)
                    mp, vp = runs(K.fused_rollout_returns_plain)
                    # per row, z = dmean / se is ~t with ~30 degrees of freedom: its
                    # square averages ~1.07 over the 640 rows (standard error ~0.06)
                    z = (mk - mp) / ((vk + vp) / launches).sqrt()
                    z_max, z2 = float(z.abs().max()), float((z**2).mean())
                    ratio = float(vk.mean() / vp.mean())
                    check(z_max < 7 and 0.7 < z2 < 1.5 and 0.8 < ratio < 1.25,
                          f"{what}: sampled returns differ, max |dmean|/se {z_max}, mean "
                          f"(dmean/se)^2 {z2}, var ratio {ratio}")
                    samples[f"K1/{dt_name}/{width}"] = (z_max, z2, ratio)
    return {"max_abs_err": errs, "samples": samples}


def wide_clusters(K, stack, k1: bool, tiles: int, members: int, what: str):
    """K1's or K2's wide grid in clusters of ``kernels.WIDE_CLUSTER`` blocks
    at ``tiles`` row tiles of each of ``members``: its blocks and clusters
    beside the clusters the card holds at once; fails unless they fit in one
    wave."""
    cluster = K.WIDE_CLUSTER
    blocks = K.wide_grid(tiles, cluster) * members
    held = K.wide_max_active_clusters(stack, k1, cluster, torch.device("cuda"), OBS_A)
    check(blocks // cluster <= held,
          f"{what}: {blocks // cluster} clusters of {cluster} but the card holds {held} at once")
    return {"cluster": cluster, "blocks": blocks, "clusters": blocks // cluster,
            "max_active_clusters": held}


def wide_kernel_checks():
    """K3, K2 and K1 on the wide route at ``WIDE_HID`` columns: the shapes of
    K3 ``C8k`` and ``C100k``, K2 ``B`` and K1 ``A`` with a 4 x ``WIDE_HID``
    model (the port's init, 5 elites), f32 and bf16, checked and timed as
    ``kernel_checks`` does, on the route each wrapper picks (K3, and bf16 K1
    and K2: the activations resident in shared memory); K3 at ``C8k`` with a
    4 x ``WIDEST_HID`` model on its scratch route; then K2 and K1 in clusters of
    ``kernels.WIDE_CLUSTER`` blocks that share each weight chunk, checked and
    timed alike, their clusters in one wave."""
    from mbrl_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(SEED + 11)
    dev = torch.device("cuda")
    results = {}
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        stack, max_lv, min_lv = elite_stack(OBS_B + ACT, OBS_B, dtype, g, hid=WIDE_HID)
        check(not K.takes_chain(stack.dims, stack.low_precision), "a 512-wide stack took the chain")
        x = torch.randn((ELITES, BATCH // ELITES, OBS_B + ACT), generator=g).to(dev)
        results[("K3@W512", dt_name)] = check_k3(K, x, stack, dt_name, f"{WIDE_HID} wide")
        results[("K2@W512", dt_name)] = check_k2(K, g, x, stack, max_lv, min_lv, dt_name,
                                                 f"{WIDE_HID} wide")
        results[("K2@W512/cluster", dt_name)] = {
            **check_k2(K, g, x, stack, max_lv, min_lv, dt_name, f"{WIDE_HID} wide, clusters",
                       cluster=K.WIDE_CLUSTER),
            **wide_clusters(K, stack, False, -(-(BATCH // ELITES) // K.MAX_TILE), ELITES,
                            f"K2 {dt_name} {WIDE_HID} wide")}
        stack, max_lv, min_lv = elite_stack(OBS_A + ACT, OBS_A + 1, dtype, g, hid=WIDE_HID)
        # K3 at the MBPO rollout's shape: E=5 x S=20,000, in 23, head 36
        x = torch.randn((ELITES, MBPO_ROWS // ELITES, OBS_A + ACT), generator=g).to(dev)
        results[("K3@W512C100k", dt_name)] = check_k3(K, x, stack, dt_name,
                                                      f"{WIDE_HID} wide, C100k")
        del x
        # K3 at C's 8,000 rows with a 4 x WIDEST_HID model: its scratch route
        wider, _, _ = elite_stack(OBS_B + ACT, OBS_B, dtype, g, hid=WIDEST_HID)
        x = torch.randn((ELITES, BATCH // ELITES, OBS_B + ACT), generator=g).to(dev)
        results[("K3@W1024", dt_name)] = check_k3(K, x, wider, dt_name, f"{WIDEST_HID} wide")
        del x, wider
        results[("K1@W512", dt_name)] = check_k1(K, g, stack, max_lv, min_lv, dt_name,
                                                 f"{WIDE_HID} wide")
        results[("K1@W512/cluster", dt_name)] = {
            **check_k1(K, g, stack, max_lv, min_lv, dt_name, f"{WIDE_HID} wide, clusters",
                       cluster=K.WIDE_CLUSTER),
            **wide_clusters(K, stack, True, BATCH // K.pick_tile(BATCH // ELITES), 1,
                            f"K1 {dt_name} {WIDE_HID} wide")}
        print(f"wide route {WIDE_HID} {dt_name}: " + json.dumps(
            {k[0]: results[k] for k in results if k[1] == dt_name}), flush=True)
    return results


# --------------------------------------------------------------------------- #
# Phases 3-5: the main path through the port's entry points
# --------------------------------------------------------------------------- #
def build_config(name: str, device: str, g: torch.Generator, identical: bool = False,
                 dtype: str = "bfloat16", hid: int = HID):
    """Config A (with its model in ``dtype``), B or D, with ``hid``-wide layers:
    environment, state, obs width."""
    from mbrl_tpu_torch.envs import reward_fns, termination_fns
    from mbrl_tpu_torch.envs.pets_halfcheetah import HalfCheetahEnv
    from mbrl_tpu_torch.models import GaussianMLP, ModelEnv, TransitionRewardModel

    if name == "A":
        # bench.py:_build_env: learned rewards, rotate, bf16
        model = GaussianMLP(OBS_A + ACT, OBS_A + 1, LAYERS, ENSEMBLE, hid, activation="silu",
                            propagation_method="random_model", rollout_shuffle="rotate",
                            compute_dtype=dtype, device=device)
        wrapper = TransitionRewardModel(model, target_is_delta=True, normalize=True,
                                        learned_rewards=True)
        env_kw = {}
        obs_dim = OBS_A
    else:
        # B: overrides/pets_halfcheetah.yaml + gaussian_mlp_ensemble.yaml; D: the
        # same with that file's `deterministic` knob on
        model = GaussianMLP(OBS_B + ACT, OBS_B, LAYERS, ENSEMBLE, hid, activation="silu",
                            propagation_method="random_model", rollout_shuffle="sort",
                            deterministic=name == "D", device=device)
        wrapper = TransitionRewardModel(model, target_is_delta=True, normalize=True,
                                        learned_rewards=False,
                                        obs_process_fn=HalfCheetahEnv.preprocess_fn,
                                        no_delta_list=[0])
        env_kw = {"reward_fn": reward_fns.halfcheetah}
        obs_dim = OBS_B
    state = wrapper.set_elite(wrapper.init(g), list(range(ELITES)))
    if identical:
        # every member carries member 0's weights and the noise is ~e^-10, so
        # the member schedule cannot matter and any device path must agree
        params = state["params"]
        for leaf in [l for layer in params["layers"] for l in layer.values()] + list(params["head"].values()):
            leaf.copy_(leaf[:1].clone().expand_as(leaf))
        if not model.deterministic:
            params["min_logvar"].fill_(-20.0)
            params["max_logvar"].fill_(-19.0)
    env = ModelEnv(wrapper, termination_fns.no_termination, **env_kw)
    return env, state, obs_dim


def agreement(name: str, pop: int) -> float:
    """The card's rollout vs the plain CPU path, same identical-member weights."""
    vals = {}
    g_seq = torch.Generator().manual_seed(SEED + 7)
    for device in ("cuda", "cpu"):
        env, state, obs_dim = build_config(name, device, torch.Generator().manual_seed(SEED + 3), True)
        seqs = torch.rand((pop, HORIZON, ACT), generator=torch.Generator().manual_seed(SEED + 4)) * 2 - 1
        obs0 = 0.1 * torch.randn((obs_dim,), generator=g_seq.manual_seed(SEED + 5))
        v = env.evaluate_action_sequences(state, seqs, obs0, torch.Generator().manual_seed(1), PARTICLES)
        vals[device] = v.float().cpu()
    err = float((vals["cuda"] - vals["cpu"]).abs().max())
    scale = float(vals["cpu"].abs().max())
    tol = (2e-2 if name == "A" else 1e-3) * (1.0 + scale)
    check(np.isfinite(vals["cuda"].numpy()).all() and err <= tol,
          f"config {name}: card vs CPU returns differ by {err} (tol {tol})")
    return err


def make_agent(name: str, device: str = "cuda", hid: int = HID):
    """The CEM MPC agent of config A, B or D: 5 iterations, elite ratio 0.16,
    alpha 0.12, mean of the elites, actions in [-1, 1]."""
    from mbrl_tpu_torch.planning import (
        CEMOptimizer, TrajectoryOptimizerAgent, create_trajectory_optim_agent_for_model,
    )

    g = torch.Generator().manual_seed(SEED + 1)
    env, state, obs_dim = build_config(name, device, g, hid=hid)
    lb, ub = -np.ones(ACT, np.float32), np.ones(ACT, np.float32)
    cem = CEMOptimizer(5, 0.16, POP, np.tile(lb, (HORIZON, 1)), np.tile(ub, (HORIZON, 1)),
                       alpha=0.12, return_mean_elites=True, device=device)
    agent = TrajectoryOptimizerAgent(cem, lb, ub, planning_horizon=HORIZON, replan_freq=1, seed=SEED)
    agent = create_trajectory_optim_agent_for_model(env, agent, num_particles=PARTICLES)
    agent.set_eval_state(state)
    return agent, obs_dim


def plan_config(name: str, device: str = "cuda", hid: int = HID, acts: int = 3):
    agent, obs_dim = make_agent(name, device, hid)
    lb, ub = -np.ones(ACT, np.float32), np.ones(ACT, np.float32)
    rng = np.random.default_rng(SEED)
    times = []
    for _ in range(acts):
        obs = (0.1 * rng.standard_normal(obs_dim)).astype(np.float32)
        sync(device)
        t0 = time.perf_counter()
        action = agent.act(obs)
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        check(action.shape == (ACT,) and np.isfinite(action).all(), f"config {name}: bad action {action}")
        check(bool((action >= lb - 1e-6).all() and (action <= ub + 1e-6).all()),
              f"config {name}: action out of bounds {action}")
    return times


# the CUDA kernels of K1, K2 and K3: on the chain, then on the wide route,
# then K3's two other chain routes (kernels.k3_route: two tiles a block, a
# cluster a member) and its resident wide route
PORT_KERNELS = ("rollout_returns_tc_kernel", "gaussian_tc_kernel", "ensemble_mlp_tc_kernel",
                "rollout_returns_wide_tc_kernel", "gaussian_wide_tc_kernel",
                "ensemble_mlp_wide_tc_kernel", "ensemble_mlp_pair_kernel",
                "ensemble_mlp_cluster_kernel", "ensemble_mlp_wide_smem_kernel")
# K3's kernel on each of its routes (check_k3's "route") and its source
K3_KERNELS = {"tile": "ensemble_mlp_tc_kernel", "pair": "ensemble_mlp_pair_kernel",
              "cluster": "ensemble_mlp_cluster_kernel", "wide/scratch": "ensemble_mlp_wide_tc_kernel",
              "wide/smem": "ensemble_mlp_wide_smem_kernel"}
K3_SOURCES = {"tile": "mbrl_tpu_torch/csrc/ensemble_mlp.cu", "pair": "mbrl_tpu_torch/csrc/ensemble_mlp.cu",
              "cluster": "mbrl_tpu_torch/csrc/ensemble_mlp.cu",
              "wide/scratch": "mbrl_tpu_torch/csrc/ensemble_mlp_wide.cu",
              "wide/smem": "mbrl_tpu_torch/csrc/ensemble_mlp_wide_smem.cu"}


def device_busy(name: str, acts: int = 2, hid: int = HID):
    """Warm ``act``s of config A, B or D under ``torch.profiler`` (``profile_busy``)."""
    agent, obs_dim = make_agent(name, hid=hid)
    rng = np.random.default_rng(SEED)
    agent.act((0.1 * rng.standard_normal(obs_dim)).astype(np.float32))

    def run():
        for _ in range(acts):
            agent.act((0.1 * rng.standard_normal(obs_dim)).astype(np.float32))

    return {"acts": acts, **profile_busy(run, PORT_KERNELS)}


def run_steps(env, state, obs_dim: int, device: str, g: torch.Generator, rows: int, steps: int,
              prepare: bool):
    """``steps`` ``ModelEnv.step``s on ``rows`` particles with uniform random
    actions, after ``prepare_rollout`` if asked; ms per step. The elite
    weights must be packed once for all the steps."""
    model = env.dynamics_model.model
    obs = 0.1 * torch.randn((rows, obs_dim), generator=g)
    model_state = env.reset(state, obs, g)
    if prepare:
        model_state = env.dynamics_model.prepare_rollout(state, model_state, steps, g)
    times = []
    for _ in range(steps):
        act = (torch.rand((rows, ACT), generator=g) * 2 - 1).to(device)
        sync(device)
        t0 = time.perf_counter()
        next_obs, rewards, term, model_state = env.step(state, act, model_state, g)
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        check(tuple(next_obs.shape) == (rows, obs_dim) and tuple(rewards.shape) == (rows, 1),
              f"config C: bad shapes {tuple(next_obs.shape)} {tuple(rewards.shape)}")
        check(bool(torch.isfinite(next_obs).all() and torch.isfinite(rewards).all()),
              "config C: non-finite step output")
    check(model.packs == 1, f"config C: weights packed {model.packs} times in {steps} steps, not once")
    return times


def step_config_c(device: str = "cuda"):
    """5 ``ModelEnv.step``s on the planner's ``BATCH`` particles, config B's model."""
    g = torch.Generator().manual_seed(SEED + 2)
    env, state, obs_dim = build_config("B", device, g)
    return run_steps(env, state, obs_dim, device, g, BATCH, 5, prepare=False)


def rollout_config_c(device: str = "cuda"):
    """The MBPO-shaped rollout: ``MBPO_STEPS`` steps on ``MBPO_ROWS`` rows of
    config A's model (obs 17, learned reward) in f32, MBPO's dtype
    (dynamics_model/gaussian_mlp_ensemble.yaml), after ``prepare_rollout``."""
    g = torch.Generator().manual_seed(SEED + 2)
    env, state, obs_dim = build_config("A", device, g, dtype="float32")
    return run_steps(env, state, obs_dim, device, g, MBPO_ROWS, MBPO_STEPS, prepare=True)


# --------------------------------------------------------------------------- #
# Config E: a whole PETS run through algorithms.pets.train
# --------------------------------------------------------------------------- #
_CEM_E = {
    "_target_": "mbrl_tpu_torch.planning.CEMOptimizer",
    "num_iterations": 5, "elite_ratio": 0.1, "population_size": 350, "alpha": 0.1,
    "lower_bound": "???", "upper_bound": "???", "return_mean_elites": True,
    "clipped_normal": False,
}
# examples/conf/main.yaml with algorithm=pets, dynamics_model=gaussian_mlp_ensemble,
# overrides=pets_cartpole, action_optimizer=cem, parallel=none, interpolations
# resolved; tests/test_torch_config.py holds it equal to the loaded YAML tree
# apart from overrides.num_steps
CONFIG_E = {
    "algorithm": {
        "name": "pets",
        "agent": {
            "_target_": "mbrl_tpu_torch.planning.TrajectoryOptimizerAgent",
            "action_lb": "???", "action_ub": "???", "planning_horizon": 15,
            "optimizer": copy.deepcopy(_CEM_E), "replan_freq": 1, "verbose": False,
        },
        "normalize": True, "normalize_double_precision": True, "target_is_delta": True,
        "initial_exploration_steps": 200, "freq_train_model": 50, "learned_rewards": False,
        "num_particles": 20,
    },
    "dynamics_model": {
        "_target_": "mbrl_tpu_torch.models.GaussianMLP",
        "num_layers": 4, "in_size": "???", "out_size": "???", "ensemble_size": 7,
        "hid_size": 200, "deterministic": False, "propagation_method": "random_model",
        "learn_logvar_bounds": False, "activation": "silu",
    },
    "overrides": {
        "env": "cartpole_continuous", "term_fn": "cartpole", "reward_fn": "cartpole",
        "learned_rewards": False, "trial_length": 200, "num_steps": E_PLANNED_STEPS,
        "num_elites": 5, "model_lr": 7.5e-4, "model_wd": 3e-5, "model_batch_size": 256,
        "validation_ratio": 0, "freq_train_model": 50, "patience": 25,
        "num_epochs_train_model": 25, "planning_horizon": 15, "cem_num_iters": 5,
        "cem_elite_ratio": 0.1, "cem_population_size": 350, "cem_alpha": 0.1,
        "cem_clipped_normal": False,
    },
    "action_optimizer": copy.deepcopy(_CEM_E),
    "parallel": {"enable": False},
    "seed": 0, "log_frequency_agent": 1000, "save_video": False, "debug_mode": False,
    "experiment": "default", "root_dir": "./exp",
}


class RecordingEnv:
    """Wraps an environment, keeping each step's action, each episode's
    reward and, per step, the host time since the step or reset before it
    returned. In ``pets.train`` and ``mbpo.train`` that gap is the agent's
    ``act`` (which returns a numpy action, so the card has finished) and
    whatever the loop did after the step before: a retraining, a bundle of
    SAC updates, an evaluation."""

    def __init__(self, env):
        self.env = env
        self.observation_space, self.action_space = env.observation_space, env.action_space
        self.episode_rewards, self.actions, self.gap_ms = [], [], []

    def reset(self, **kw):
        self.episode_rewards.append(0.0)
        out = self.env.reset(**kw)
        self._returned = time.perf_counter()
        return out

    def step(self, action):
        self.gap_ms.append((time.perf_counter() - self._returned) * 1e3)
        self.actions.append(np.asarray(action, np.float64).reshape(-1))
        out = self.env.step(action)
        self.episode_rewards[-1] += out[1]
        self._returned = time.perf_counter()
        return out


def seeded_cartpole(env=None):
    """The port's continuous cartpole (or ``env`` wrapping one), seeded with ``SEED``."""
    from mbrl_tpu_torch.envs.cartpole_continuous import CartPoleEnv

    env = CartPoleEnv() if env is None else env
    getattr(env, "unwrapped", env).np_random = np.random.default_rng(SEED)
    env.action_space.seed(SEED)
    return env


def read_csv(path) -> dict:
    """Columns of a csv file that ``util.logger.Logger`` wrote, as float lists."""
    import csv

    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {k: [float(r[k]) for r in rows] for k in rows[0]}


def pets_config_e(device: str = "cuda", planned_steps: int = E_PLANNED_STEPS, config=None,
                  label: str = "E"):
    """``pets.train`` on the port's continuous cartpole with ``CONFIG_E`` (or
    ``config``, e.g. ``CONFIG_BE``; ``label`` names it in messages). Returns
    the run's numbers, the model it trained (its wrapper, and the state loaded
    from the ``model.pkl`` it wrote) and its work directory (the caller
    removes it)."""
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_pets_")
    try:
        return _pets_config_e(device, planned_steps, config, work_dir, label)
    except BaseException:
        shutil.rmtree(work_dir, ignore_errors=True)
        raise


def _pets_config_e(device, asked, config, work_dir, label="E"):
    import contextlib
    import io
    from unittest import mock

    from mbrl_tpu_torch.algorithms import pets
    from mbrl_tpu_torch.config import Config
    from mbrl_tpu_torch.envs import reward_fns, termination_fns
    from mbrl_tpu_torch.util.replay_buffer import ReplayBuffer

    cfg = Config(copy.deepcopy(CONFIG_E if config is None else config))
    cfg.overrides["num_steps"] = asked
    explore, freq = cfg.algorithm.initial_exploration_steps, cfg.algorithm.freq_train_model
    env = RecordingEnv(seeded_cartpole())
    # pets.train builds its model itself and returns the best reward only: keep
    # the wrapper it builds (for `model.packs`); the rest is read from what the
    # run writes. The logger's table of every epoch goes to a buffer, not stdout.
    wrappers, saved = [], []

    def build_model(*a, **kw):  # keeps each state the run saves, as it was in memory
        wrappers.append(create(*a, **kw))
        save = wrappers[-1].save

        def saving(state, save_dir):
            saved.append(state)
            return save(state, save_dir)

        wrappers[-1].save = saving
        return wrappers[-1]

    create = pets.create_one_dim_tr_model
    with mock.patch.object(pets, "create_one_dim_tr_model", build_model), \
            contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        best = pets.train(env, termination_fns.cartpole, reward_fns.cartpole, cfg, silent=False,
                          work_dir=work_dir, device=device)
        total_s = time.perf_counter() - t0
    (wrapper,) = wrappers

    # pets.train ends at the first episode boundary at or after num_steps
    planned_steps = len(env.actions) - explore
    retrainings = -(-planned_steps // freq)
    check(asked <= planned_steps < asked + cfg.overrides.trial_length,
          f"config {label}: {planned_steps} planned steps for num_steps {asked}")
    actions = np.stack(env.actions[explore:])
    check(actions.shape == (planned_steps, ACT_E) and bool(np.isfinite(actions).all())
          and bool((np.abs(actions) <= 1.0 + 1e-6).all()), f"config {label}: action not finite or out of bounds")
    # one fresh pack per retraining, made at the first plan after it (a
    # BasicEnsemble packs nothing: it runs no kernel)
    packs = getattr(wrapper.model, "packs", retrainings)
    check(packs == retrainings,
          f"config {label}: weights packed {packs} times for {retrainings} retrainings")

    # what the run wrote loads again
    work = pathlib.Path(work_dir)
    check((work / "model.pkl").exists() and (work / "replay_buffer.npz").exists(),
          f"config {label}: model.pkl or replay_buffer.npz not written")
    # the buffer's capacity is overrides.num_steps, so the cut run's ring wraps
    buffer = ReplayBuffer(cfg.overrides.num_steps, (OBS_E,), (ACT_E,), obs_type=np.double,
                          action_type=np.double, reward_type=np.double)
    buffer.load(work)
    # saved at the last retraining
    saved_rows = explore + (retrainings - 1) * freq
    check(buffer.num_stored == min(saved_rows, cfg.overrides.num_steps),
          f"replay_buffer.npz: {buffer.num_stored} rows")
    init = wrapper.init(torch.Generator().manual_seed(cfg.seed or 0))  # the run's initial weights
    state = wrapper.load(init, work)
    check(state["params"]["elite"].shape == (ELITES,) and
          state["normalizer"].mean.dtype == torch.float64, "model.pkl: elites or normalizer lost")
    # ... and is the last retraining's state as it was in memory, bit for bit
    from mbrl_tpu_torch.ops.tree import tree_leaves_with_path

    last = saved[-1]
    pairs = list(zip(tree_leaves_with_path(state["params"]), tree_leaves_with_path(last["params"])))
    pairs += [((("mean",), state["normalizer"].mean), (("mean",), last["normalizer"].mean)),
              ((("std",), state["normalizer"].std), (("std",), last["normalizer"].std))]
    check(len(saved) == retrainings and all(
        pa == pb and torch.equal(a.to(b.device), b) for (pa, a), (pb, b) in pairs),
        f"config {label}: model.pkl is not the last retraining's state ({len(saved)} saves)")

    # the retrainings, from the model_train.csv the run's logger wrote
    log = read_csv(work / "model_train.csv")
    check(bool(np.isfinite(log["model_loss"]).all() and np.isfinite(log["model_val_score"]).all()),
          f"config {label}: non-finite training loss or validation score")
    iteration = np.asarray(log["train_iteration"], int)
    check(sorted(set(iteration)) == list(range(retrainings)),
          f"config {label}: retrainings logged {sorted(set(iteration))}, expected {retrainings}")
    losses = [np.asarray(log["model_loss"])[iteration == i] for i in range(retrainings)]
    scores = [np.asarray(log["model_val_score"])[iteration == i] for i in range(retrainings)]
    epochs = len(iteration)
    steps = int(sum(log["train_dataset_size"])) // cfg.overrides.model_batch_size
    # it learned: on the rows the buffer holds, the saved model scores below the
    # initial weights (both behind the saved normalizer)
    rows = buffer.get_all().to(device)
    with torch.no_grad():
        score_init = float(wrapper.eval_score({**init, "normalizer": state["normalizer"]}, rows)[0].mean())
        score_last = float(wrapper.eval_score(state, rows)[0].mean())
    check(score_last < score_init, f"config {label}: the saved model's score {score_last} on the buffer "
                                   f"is not below the initial weights' {score_init}")

    # a step that retrains waits for the retraining (normalizer, sync, epochs,
    # both files saved) and its act (which repacks; the first also warms up):
    # the median act is taken off
    gaps = np.asarray(env.gap_ms[explore:])
    retrains = np.arange(planned_steps) % freq == 0
    act_ms = gaps[~retrains]
    retrain_ms = gaps[retrains] - float(np.median(act_ms))
    explored = int(np.searchsorted(np.cumsum(env.episode_rewards), explore)) + 1
    numbers = {
        "num_steps": asked, "planned_steps": planned_steps, "published_num_steps": 5000,
        "retrainings": retrainings,
        "total_s": total_s, "best_episode_reward": float(best),
        "exploration_episode_rewards": env.episode_rewards[:explored],
        "planned_episode_rewards": env.episode_rewards[explored:],
        "act_ms_median": float(np.median(act_ms)),
        "act_ms_mean": float(np.mean(act_ms)),
        "retrain_ms": retrain_ms.tolist(),
        "retrain_rows": [min(explore + i * freq, cfg.overrides.num_steps) for i in range(retrainings)],
        "epoch_ms_mean": float(retrain_ms.sum()) / epochs, "gradient_steps": steps,
        "gradient_steps_per_s": steps / (float(retrain_ms.sum()) / 1e3),
        "retrain_ms_per_env_step": float(retrain_ms.sum()) / planned_steps,
        "score_on_buffer": {"initial_weights": score_init, "saved_model": score_last},
        "first_scores": [float(scores[0][0]), float(scores[0].min())],
        "last_scores": [float(scores[-1][0]), float(scores[-1].min())],
        "first_losses": [float(losses[0][0]), float(losses[0][-1])],
        "last_losses": [float(losses[-1][0]), float(losses[-1][-1])],
    }
    return numbers, wrapper, state, work_dir


# --------------------------------------------------------------------------- #
# Config T: training alone at PETS-HalfCheetah's shape
# --------------------------------------------------------------------------- #
def halfcheetah_training_setup(device: str, rows: int = T_ROWS):
    """overrides/pets_halfcheetah.yaml's model (obs 18, 18 preprocessed, act 6, in 24,
    out 18, no_delta_list [0], 7 members) with weights from ``SEED``, and
    a synthetic buffer of ``rows`` transitions of a smooth random system."""
    from mbrl_tpu_torch.envs.pets_halfcheetah import HalfCheetahEnv
    from mbrl_tpu_torch.models import GaussianMLP, TransitionRewardModel
    from mbrl_tpu_torch.util.replay_buffer import ReplayBuffer

    model = GaussianMLP(OBS_B + ACT, OBS_B, LAYERS, ENSEMBLE, HID, activation="silu",
                        propagation_method="random_model", device=device)
    wrapper = TransitionRewardModel(model, target_is_delta=True, normalize=True,
                                    normalize_double_precision=True, learned_rewards=False,
                                    obs_process_fn=HalfCheetahEnv.preprocess_fn,
                                    no_delta_list=[0], num_elites=ELITES)
    state = wrapper.init(torch.Generator().manual_seed(SEED + 20))
    rng = np.random.default_rng(SEED + 21)
    obs = rng.standard_normal((rows, OBS_B))
    act = rng.uniform(-1, 1, (rows, ACT))
    mix = rng.standard_normal((OBS_B + ACT, OBS_B)) / np.sqrt(OBS_B + ACT)
    next_obs = obs + 0.1 * np.tanh(np.concatenate([obs, act], 1) @ mix) \
        + 0.01 * rng.standard_normal((rows, OBS_B))
    buffer = ReplayBuffer(rows, (OBS_B,), (ACT,), obs_type=np.double, action_type=np.double,
                          reward_type=np.double, rng=np.random.default_rng(SEED + 22))
    buffer.add_batch(obs, act, next_obs, next_obs[:, 0], np.zeros(rows, bool), np.zeros(rows, bool))
    state = wrapper.update_normalizer_host(state, buffer.get_all())
    return wrapper, state, buffer


def fixed_batch_loss_and_grads(device: str, rows: int):
    """Loss and gradients of one fixed bootstrapped batch (7 x 32 rows)."""
    from mbrl_tpu_torch.models import ModelTrainer
    from mbrl_tpu_torch.models.trainer import _Work

    wrapper, state, buffer = halfcheetah_training_setup(device, rows)
    idx = np.random.default_rng(SEED + 23).integers(0, rows, (ENSEMBLE, 32))
    batch = buffer.get_all()[idx.reshape(-1)].map(
        lambda x: x.reshape((ENSEMBLE, 32) + x.shape[1:])).to(device)
    work = _Work(ModelTrainer(wrapper), state)
    loss, _ = wrapper.loss(work.state(), batch)
    loss.backward()
    return float(loss.detach()), [leaf.grad.detach().cpu() for leaf in work.leaves]


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
    check(bool(spans), "the profiler saw no device activity")
    busy, end = 0.0, -float("inf")
    for s, e, _ in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    ours = sum(e - s for s, e, n in spans if n.split("<")[0].split()[-1] in kernels)
    by_name = {}
    for s, e, n in spans:
        by_name[n[:48]] = by_name.get(n[:48], 0.0) + (e - s) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall_us / 1e3, "device_busy_share": busy / wall_us,
            "port_kernel_share": ours / wall_us, "device_ops": len(spans),
            "top_device_ms": dict(top)}


def train_config_t(device: str = "cuda", rows: int = T_ROWS, profile: bool = True):
    """Two epochs of ``train_device`` and two of the host-iterator ``train`` at
    pets_halfcheetah.yaml's values (batch 32, validation_ratio 0.05, lr 2.8e-4,
    wd 1e-4); on the card, the loss and the gradient of one fixed batch against
    the CPU."""
    from mbrl_tpu_torch.models import ModelTrainer
    from mbrl_tpu_torch.models.trainer import _device_sizes
    from mbrl_tpu_torch.util.common import get_basic_buffer_iterators
    from mbrl_tpu_torch.util.device_buffer import DeviceTransitionDataset

    out = {"rows": rows}
    if device == "cuda":
        loss_d, grads_d = fixed_batch_loss_and_grads("cuda", rows)
        loss_c, grads_c = fixed_batch_loss_and_grads("cpu", rows)
        # f32 on both sides (PyTorch's f32 products on the card are not TF32
        # unless asked): they differ by summation order only
        tol = 1e-4
        worst = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(grads_d, grads_c))
        check(abs(loss_d - loss_c) <= tol * abs(loss_c) and worst <= tol,
              f"config T: card vs CPU loss {loss_d} vs {loss_c}, worst gradient error {worst} "
              f"relative to the leaf's largest entry (tol {tol})")
        out.update({"loss_card": loss_d, "loss_cpu": loss_c, "grad_max_rel_err": worst, "tol": tol})

    wrapper, state, buffer = halfcheetah_training_setup(device, rows)
    kw = dict(optim_lr=2.8e-4, weight_decay=1e-4)
    dataset = DeviceTransitionDataset(OBS_B, ACT, device=device)
    dataset.sync_from(buffer)
    _, steps = _device_sizes(rows, dataset.capacity, 32, 0.05)

    def timed(fn):
        sync(device)
        t0 = time.perf_counter()
        result = fn()
        sync(device)
        return result, (time.perf_counter() - t0) * 1e3

    trainer = ModelTrainer(wrapper, **kw)
    (_, losses, scores), ms = timed(lambda: trainer.train_device(
        state, dataset, batch_size=32, val_ratio=0.05, num_epochs=2, patience=2))
    check(len(losses) == 2 and bool(np.isfinite(losses + scores).all()) and losses[1] < losses[0],
          f"config T train_device: losses {losses} scores {scores} not finite and falling")
    out["train_device"] = {"epoch_ms": ms / 2, "steps_per_epoch": steps,
                           "steps_per_s": 2 * steps / (ms / 1e3), "losses": losses, "scores": scores}

    train_it, val_it = get_basic_buffer_iterators(buffer, 32, 0.05, ensemble_size=ENSEMBLE,
                                                  shuffle_each_epoch=True)
    trainer = ModelTrainer(wrapper, **kw)
    (_, losses, scores), ms = timed(lambda: trainer.train(
        state, train_it, dataset_val=val_it, num_epochs=2, patience=2))
    check(len(losses) == 2 and bool(np.isfinite(losses + scores).all()) and losses[1] < losses[0],
          f"config T train: losses {losses} scores {scores} not finite and falling")
    host_steps = -(-len(train_it) // 8) * 8
    out["train_host"] = {"epoch_ms": ms / 2, "steps_per_epoch": host_steps,
                         "steps_per_s": 2 * host_steps / (ms / 1e3), "losses": losses,
                         "scores": scores}
    if profile and device == "cuda":
        trainer = ModelTrainer(wrapper, **kw)
        out["train_device_profile"] = profile_busy(lambda: trainer.train_device(
            state, dataset, batch_size=32, val_ratio=0.05, num_epochs=1, patience=1))
    return out


# --------------------------------------------------------------------------- #
# MPPI, iCEM and act_batch on the kernels
# --------------------------------------------------------------------------- #
def timed_acts(agent, observations, device: str, lb, ub, what: str):
    """One warm-up ``act`` and the rest timed; every action finite and in bounds."""
    times = []
    for obs in observations:
        sync(device)
        t0 = time.perf_counter()
        action = agent.act(obs)
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        check(bool(np.isfinite(action).all() and (action >= lb - 1e-6).all()
                   and (action <= ub + 1e-6).all()), f"{what}: action {action} not finite or out of bounds")
    return times[1:]


def plan_mppi(device: str = "cuda", population: int = MPPI_POP):
    """MPPI at overrides/pets_mppi_halfcheetah.yaml's values (5 iterations x 350
    candidates, gamma 0.9, sigma 1.0, beta 0.9, horizon 30) on config B's model."""
    from mbrl_tpu_torch.planning import (
        MPPIOptimizer, TrajectoryOptimizerAgent, create_trajectory_optim_agent_for_model,
    )

    env, state, obs_dim = build_config("B", device, torch.Generator().manual_seed(SEED + 1))
    lb, ub = -np.ones(ACT, np.float32), np.ones(ACT, np.float32)
    mppi = MPPIOptimizer(5, population, gamma=0.9, sigma=1.0, beta=0.9,
                         lower_bound=np.tile(lb, (HORIZON, 1)), upper_bound=np.tile(ub, (HORIZON, 1)),
                         device=device)
    agent = TrajectoryOptimizerAgent(mppi, lb, ub, planning_horizon=HORIZON, seed=SEED)
    agent = create_trajectory_optim_agent_for_model(env, agent, num_particles=PARTICLES)
    agent.set_eval_state(state)
    rng = np.random.default_rng(SEED)
    means = []
    orig = mppi.optimize

    def spy(obj_fun, x0, generator, opt_state, *a, **kw):
        means.append(opt_state.clone())
        sol, new = orig(obj_fun, x0, generator, opt_state, *a, **kw)
        means.append(new.clone())
        return sol, new

    agent.optimizer.optimizer.optimize = spy
    times = timed_acts(agent, [(0.1 * rng.standard_normal(obs_dim)).astype(np.float32)
                               for _ in range(3)], device, lb, ub, "MPPI")
    # the mean handed to a call is the one the call before returned (optimize
    # shifts it by one step itself; the trajectory optimizer must not)
    check(torch.equal(means[2], means[1]) and torch.equal(means[4], means[3]),
          "MPPI: the persistent mean was changed between calls")
    agent.optimizer.optimizer.refinements = 0
    shifted, _ = orig(None, None, agent._generator, means[5])
    check(torch.equal(shifted[:-1], means[5][1:]) and torch.equal(shifted[-1], means[5][-1]),
          "MPPI: optimize does not shift its mean by one step")
    return times


def plan_icem(wrapper, state, device: str = "cuda", population: int = 200):
    """iCEM (``icem_optimizer``) on config E's model."""
    from mbrl_tpu_torch.envs import reward_fns, termination_fns
    from mbrl_tpu_torch.models import ModelEnv
    from mbrl_tpu_torch.planning import (
        TrajectoryOptimizerAgent, create_trajectory_optim_agent_for_model,
    )

    horizon = ICEM_HORIZON
    lb, ub = -np.ones(ACT_E, np.float32), np.ones(ACT_E, np.float32)
    icem = icem_optimizer(device, population)
    env = ModelEnv(wrapper, termination_fns.cartpole, reward_fns.cartpole)
    agent = TrajectoryOptimizerAgent(icem, lb, ub, planning_horizon=horizon, seed=SEED)
    agent = create_trajectory_optim_agent_for_model(env, agent, num_particles=PARTICLES)
    agent.set_eval_state(state)
    rng = np.random.default_rng(SEED)
    sizes = []
    times = timed_acts(agent, [rng.uniform(-0.05, 0.05, OBS_E).astype(np.float32) for _ in range(3)],
                       device, lb, ub, "iCEM")
    agent.plan(np.zeros(OBS_E, np.float32),
               optimizer_callback=lambda pop, vals, it: sizes.append(int(pop.shape[0])))
    want = icem_evaluated(icem)
    check(sizes == want, f"iCEM: population sizes {sizes}, expected {want}")
    return times, {"decay_population_sizes": icem.decay_population_sizes,
                   "keep_elite_size": icem.keep_elite_size, "evaluated": sizes,
                   "rows_per_member": icem_rows_per_member(icem)}, horizon


def act_batch_config_b(device: str = "cuda", workers: int = 4):
    """``act_batch`` with ``workers`` observations at config B: one plan per
    environment, each with its own warm start and cache; ``reset_mask`` resets one."""
    agent, obs_dim = make_agent("B", device)
    rng = np.random.default_rng(SEED)
    obs = (0.1 * rng.standard_normal((workers, obs_dim))).astype(np.float32)
    times = []
    for mask in (None, None, np.arange(workers) == 1):
        sync(device)
        t0 = time.perf_counter()
        actions = agent.act_batch(obs, reset_mask=mask)
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        check(actions.shape == (workers, ACT) and bool(np.isfinite(actions).all())
              and bool((np.abs(actions) <= 1 + 1e-6).all()), f"act_batch: bad actions {actions}")
        planners = agent._batch_state["planners"]
        if mask is None:
            warm = [p.previous_solution.clone() for p in planners]
    check(len(planners) == workers and len({id(p) for p in planners}) == workers
          and not torch.equal(warm[0], warm[1]), "act_batch: the environments share a warm start")
    return times


# --------------------------------------------------------------------------- #
# The wide route on the main path's entry points
# --------------------------------------------------------------------------- #
def wide_paths(device: str = "cuda"):
    """A ``WIDE_HID``-wide model through the entry points: two ``act``s of
    config A (K1) and of config B (K2), the first of each on a fresh agent
    (it packs the model), and ``GaussianMLP._forward_sharded`` (one K3
    launch each, on the model's wide tiles): on C's 8,000 rows against the
    same model on the CPU; on C's 100,000 rows with A's model widths (in 23),
    past one wave, and on 8,000 rows with a ``WIDEST_HID``-wide model (K3's
    scratch route), each against the plain version on the same device."""
    from mbrl_tpu_torch.models import GaussianMLP
    from mbrl_tpu_torch.ops import kernels as K

    out = {"act_ms_A": plan_config("A", device, hid=WIDE_HID, acts=2),
           "act_ms_B": plan_config("B", device, hid=WIDE_HID, acts=2)}

    def sharded(in_size, out_size, hid, rows, dev, seed, resident, with_plain=True):
        """_forward_sharded of a hid-wide model on rows random rows: (mean,
        logvar), the same with K3's plain version (if ``with_plain``), and the
        K3 launches it made."""
        x = torch.randn((rows, in_size), generator=torch.Generator().manual_seed(seed))
        perm = torch.randperm(rows, generator=torch.Generator().manual_seed(seed + 1))
        model = GaussianMLP(in_size, out_size, LAYERS, ENSEMBLE, hid, activation="silu",
                            propagation_method="random_model", device=dev)
        params = model.set_elite(model.init(torch.Generator().manual_seed(seed + 2)),
                                 list(range(ELITES)))
        packed = model.packed(params)
        check(not K.takes_chain(packed.stack.dims, False), f"a {hid}-wide model took the chain")
        check(dev == "cpu" or (isinstance(packed.tiles.layout, K.WideTileLayout)
                               and packed.tiles.layout.k3_resident == resident),
              f"a {hid}-wide model was not packed for K3's {'resident' if resident else 'scratch'} "
              "wide route")
        before = K.fused_ensemble_mlp.launches
        got = model._forward_sharded(params, x.to(dev), perm.to(dev))
        launches = K.fused_ensemble_mlp.launches - before
        if not with_plain:
            return got, None, launches
        kernel = K.fused_ensemble_mlp
        K.fused_ensemble_mlp = lambda h, stack, tiles=None: K.fused_ensemble_mlp_plain(h, stack)
        try:  # the same call with K3's plain version in its place
            plain = model._forward_sharded(params, x.to(dev), perm.to(dev))
        finally:
            K.fused_ensemble_mlp = kernel
        return got, plain, launches

    tol = TOL[("K3", "f32")]
    vals, launches = {}, {}
    for dev in (device, "cpu"):
        got, _, launches[dev] = sharded(OBS_B + ACT, OBS_B, WIDE_HID, BATCH, dev, SEED + 12, True,
                                        with_plain=False)
        vals[dev] = tuple(v.float().cpu() for v in got)
    err = max(max_err(a, b, tol)[0] for a, b in zip(vals[device], vals["cpu"]))
    check(all(max_err(a, b, tol)[1] for a, b in zip(vals[device], vals["cpu"])),
          f"_forward_sharded at {WIDE_HID} columns: card vs CPU max abs err {err} (tol {tol})")
    out["forward_sharded_max_abs_err"] = err
    runs = {f"C100k@W{WIDE_HID}": (OBS_A + ACT, OBS_A + 1, WIDE_HID, MBPO_ROWS, True),
            f"C8k@W{WIDEST_HID}": (OBS_B + ACT, OBS_B, WIDEST_HID, BATCH, False)}
    for name, (in_size, out_size, hid, rows, resident) in runs.items():
        got, plain, launches[name] = sharded(in_size, out_size, hid, rows, device, SEED + 15,
                                             resident)
        errs = [max_err(a, b, tol) for a, b in zip(got, plain)]
        check(all(ok for _, ok in errs), f"_forward_sharded {name}: kernel vs plain version max "
                                         f"abs err {max(e for e, _ in errs)} (tol {tol})")
        out[f"forward_sharded_{name}_max_abs_err"] = max(e for e, _ in errs)
    on_card = int(device == "cuda")
    want = {device: on_card, "cpu": 0, **{name: on_card for name in runs}}
    check(launches == want, f"_forward_sharded: K3 launches {launches}, not {want}")
    out["forward_sharded_launches"] = {f"C8k@W{WIDE_HID}": launches[device],
                                       **{name: launches[name] for name in runs}}
    return out


# --------------------------------------------------------------------------- #
# The propagation methods besides random_model, card against CPU
# --------------------------------------------------------------------------- #
PROPAGATION_CASES = {  # name: (members, propagation_method, rows, K3 launches on the card)
    # TSinf with its persistent propagation_indices: 1,600 rows a member over
    # the 5 elites, through _forward_sharded (K3)
    "fixed_model": (ENSEMBLE, "fixed_model", BATCH, 1),
    # a batch the elites do not shard: the member forward and a gather, as
    # the JAX package computes it outside any Pallas kernel
    "fixed_model_unsharded": (ENSEMBLE, "fixed_model", BATCH + 1, 0),
    # the mean over the elites' member forwards
    "expectation": (ENSEMBLE, "expectation", BATCH, 0),
    # dynamics_model/gaussian_mlp.yaml: one member, propagation null
    "single_model": (1, None, BATCH, 0),
}


def propagation_paths(device: str = "cuda"):
    """``GaussianMLP.forward_propagated``, the step ``ModelEnv`` takes, on the
    card against the same model on the CPU, on identical inputs (config B's
    widths: in 24, out 18, 4 x 200 silu, f32), for each of
    ``PROPAGATION_CASES``: its route (K3 launches, or the plain member
    forward of ``models/gaussian_mlp.py``), and the worst error of the mean
    and the bounded logvar."""
    from mbrl_tpu_torch.models import GaussianMLP
    from mbrl_tpu_torch.ops import kernels as K

    out = {}
    tol = TOL[("K3", "f32")]
    for name, (members, method, rows, want_k3) in PROPAGATION_CASES.items():
        g = torch.Generator().manual_seed(SEED + 40)
        x = torch.randn((rows, OBS_B + ACT), generator=g)
        indices = torch.randperm(rows, generator=g)  # the persistent assignment
        vals = {}
        for dev in (device, "cpu"):
            model = GaussianMLP(OBS_B + ACT, OBS_B, LAYERS, members, HID, activation="silu",
                                propagation_method=method, device=dev)
            params = model.init(torch.Generator().manual_seed(SEED + 41))
            if members > 1:
                params = model.set_elite(params, list(range(ELITES)))
            K.reset_launch_counts()
            mean, logvar = model.forward_propagated(params, x.to(dev),
                                                    propagation_indices=indices.to(dev))
            sync(dev)
            if dev == device:
                launches = wrapper_launches()
            vals[dev] = (mean.float().cpu(), logvar.float().cpu())
        for v in vals[device]:
            check(tuple(v.shape) == (rows, OBS_B), f"propagation {name}: shape {tuple(v.shape)}")
        errs = [max_err(a, b, tol) for a, b in zip(vals[device], vals["cpu"])]
        err = max(e for e, _ in errs)
        check(all(ok for _, ok in errs),
              f"propagation {name}: card vs CPU max abs err {err} (tol {tol})")
        if device == "cuda":
            want = {"fused_rollout_returns": 0, "fused_ensemble_mlp_gaussian": 0,
                    "fused_ensemble_mlp": want_k3}
            check(launches == want, f"propagation {name}: expected launches {want}, got {launches}")
        out[name] = {"route": "K3" if want_k3 else "plain member forward", "rows": rows,
                     "k3_launches": launches["fused_ensemble_mlp"], "max_abs_err": err, "tol": tol}
    return out


# --------------------------------------------------------------------------- #
# Config M: a whole MBPO run through algorithms.mbpo.train
# --------------------------------------------------------------------------- #
# the published MBPO cartpole run has 5,000 steps (--published-m runs them);
# the cut run takes two epochs
M_PUBLISHED_STEPS, M_NUM_STEPS = 5000, 400
# examples/conf/main.yaml with algorithm=mbpo, overrides=mbpo_cartpole,
# dynamics_model=gaussian_mlp_ensemble, interpolations resolved (the default
# action_optimizer group stays, unused and unresolved); tests/test_torch_config.py
# holds it equal to the loaded YAML tree apart from the cut num_steps, the
# dataset_size that keeps the replay buffer at the published run's 5,000 rows,
# and checkpoint_every, which makes the run save its model, buffer and a
# checkpoint at each retraining
CONFIG_M = {
    "algorithm": {
        "name": "mbpo", "normalize": True, "normalize_double_precision": True,
        "target_is_delta": True, "learned_rewards": True, "freq_train_model": 200,
        "real_data_ratio": 0.0, "sac_samples_action": True, "initial_exploration_steps": 5000,
        "random_initial_explore": False, "num_eval_episodes": 1, "dataset_size": 5000,
    },
    "dynamics_model": copy.deepcopy(CONFIG_E["dynamics_model"]),
    "overrides": {
        "env": "cartpole_continuous", "term_fn": "cartpole", "trial_length": 200,
        "num_steps": M_NUM_STEPS, "epoch_length": 200, "num_elites": 5, "patience": 5,
        "model_lr": 0.001, "model_wd": 5e-05, "model_batch_size": 256, "validation_ratio": 0.2,
        "freq_train_model": 200, "effective_model_rollouts_per_step": 400,
        "rollout_schedule": [1, 15, 1, 1], "num_sac_updates_per_step": 20,
        "sac_updates_every_steps": 1, "num_epochs_to_retain_sac_buffer": 1,
        "sac_gamma": 0.99, "sac_tau": 0.005, "sac_alpha": 0.2, "sac_policy": "Gaussian",
        "sac_target_update_interval": 4, "sac_automatic_entropy_tuning": True,
        "sac_target_entropy": -0.05, "sac_hidden_size": 256, "sac_lr": 0.0003,
        "sac_batch_size": 256,
    },
    "action_optimizer": {
        "_target_": "mbrl_tpu_torch.planning.CEMOptimizer",
        "num_iterations": "${overrides.cem_num_iters}", "elite_ratio": "${overrides.cem_elite_ratio}",
        "population_size": "${overrides.cem_population_size}", "alpha": "${overrides.cem_alpha}",
        "lower_bound": "???", "upper_bound": "???", "return_mean_elites": True,
        "clipped_normal": "${overrides.cem_clipped_normal}",
    },
    "parallel": {"enable": False},
    "seed": 0, "log_frequency_agent": 1000, "save_video": False, "debug_mode": False,
    "experiment": "default", "root_dir": "./exp", "checkpoint_every": 200,
}
OBS_M, ACT_M = 4, 1


class _Timed:
    """Wraps ``owner.name`` with a host clock between two synchronizes; keeps
    each call's ms, its arguments and its result (the caller reads them after
    the run)."""

    def __init__(self, owner, name: str, device: str):
        self.owner, self.name, self.device = owner, name, device
        self.orig = getattr(owner, name)
        self.calls = []

    def __call__(self, *args, **kwargs):
        sync(self.device)
        t0 = time.perf_counter()
        result = self.orig(*args, **kwargs)
        sync(self.device)
        self.calls.append(((time.perf_counter() - t0) * 1e3, args, kwargs, result))
        return result


def mbpo_config_m(device: str = "cuda", config=None):
    """``mbpo.train`` on the port's cartpole (``util.env.make_env``, capped at
    200 steps) with ``CONFIG_M``, printing one line at each epoch's
    evaluation. Returns the run's numbers, its work directory (the caller
    removes it) and the learner as it was at the last save of ``sac.pkl``
    (its ``SAC`` and a copy of its policy)."""
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_mbpo_")
    try:
        numbers, learner = _mbpo_config_m(device, config, work_dir)
        return numbers, work_dir, learner
    except BaseException:
        shutil.rmtree(work_dir, ignore_errors=True)
        raise


def _mbpo_config_m(device, config, work_dir):
    import contextlib
    import io
    from unittest import mock

    from mbrl_tpu_torch.algorithms import mbpo
    from mbrl_tpu_torch.config import Config
    from mbrl_tpu_torch.models import ModelTrainer
    from mbrl_tpu_torch.planning.sac import SAC
    from mbrl_tpu_torch.util.env import make_env
    from mbrl_tpu_torch.util.replay_buffer import ReplayBuffer

    cfg = Config(copy.deepcopy(CONFIG_M if config is None else config))
    env, term_fn, _ = make_env(cfg)
    test_env, _, _ = make_env(cfg)
    env = RecordingEnv(seeded_cartpole(env))
    seeded_cartpole(test_env)
    explore, freq = cfg.algorithm.initial_exploration_steps, cfg.overrides.freq_train_model
    rollouts = _Timed(mbpo, "imagined_rollout", device)
    retrains = _Timed(ModelTrainer, "train_device", device)
    bundles = _Timed(SAC, "update_from_buffer", device)
    wrappers = []
    create = mbpo.create_one_dim_tr_model

    def build_model(*a, **kw):
        wrappers.append(create(*a, **kw))
        return wrappers[-1]

    def rollout(*a, **kw):  # reads the buffer's count after the (timed) rollout
        out = rollouts(*a, **kw)
        stored.append(int(out.num_stored))
        return out

    evaluate = mbpo.evaluate
    epochs = []

    def evaluated(*a, **kw):  # one line per epoch, so a cut run shows how far it got
        reward = evaluate(*a, **kw)
        epochs.append({
            "step": len(env.actions) - explore, "eval_reward": float(reward),
            "retrain_s": retrains.calls[-1][0] / 1e3 if retrains.calls else None,
            "step_ms_median": float(np.median(env.gap_ms[-cfg.overrides.epoch_length:])),
            "elapsed_s": time.perf_counter() - t0})
        # the run's own stdout is captured below
        print("config M epoch: " + json.dumps(epochs[-1]), file=sys.__stdout__, flush=True)
        return reward

    stored = []
    learner = []  # (sac, a copy of the policy) at each save of sac.pkl
    save_checkpoint = SAC.save_checkpoint

    def saving(self, state, path):
        learner.append((self, copy.deepcopy(state.policy)))
        return save_checkpoint(self, state, path)

    # the methods patched on their classes get no `self` through a plain
    # callable: bind it
    retrain = lambda self, *a, **kw: retrains(self, *a, **kw)  # noqa: E731
    bundle = lambda self, *a, **kw: bundles(self, *a, **kw)  # noqa: E731
    t0 = time.perf_counter()
    with mock.patch.object(mbpo, "imagined_rollout", rollout), \
            mock.patch.object(ModelTrainer, "train_device", retrain), \
            mock.patch.object(SAC, "update_from_buffer", bundle), \
            mock.patch.object(mbpo, "create_one_dim_tr_model", build_model), \
            mock.patch.object(mbpo, "evaluate", evaluated), \
            mock.patch.object(SAC, "save_checkpoint", saving), \
            contextlib.redirect_stdout(io.StringIO()):
        best = mbpo.train(env, test_env, term_fn, cfg, silent=False, work_dir=work_dir,
                          device=device)
        total_s = time.perf_counter() - t0
    (wrapper,) = wrappers
    steps = cfg.overrides.num_steps
    retrainings = steps // freq
    rows = cfg.overrides.effective_model_rollouts_per_step * freq
    check(len(env.actions) == explore + steps, f"config M: {len(env.actions)} environment steps")
    check(len(retrains.calls) == retrainings and len(rollouts.calls) == retrainings,
          f"config M: {len(retrains.calls)} retrainings, {len(rollouts.calls)} rollouts")
    check(stored[0] == rows, f"config M: the SAC buffer holds {stored[0]} rows after the first "
                             f"rollout, not {rows}")
    # SAC: 20 updates a step from the step of the first rollout on
    bundle_ms = [c[0] for c in bundles.calls]
    n_updates = cfg.overrides.num_sac_updates_per_step
    check(len(bundle_ms) == steps - freq + 1, f"config M: {len(bundle_ms)} update bundles")
    metrics = {k: torch.stack([c[3][1][k] for c in bundles.calls]).cpu().numpy()
               for k in ("critic_loss", "policy_loss", "alpha_loss", "alpha")}
    check(all(bool(np.isfinite(v).all()) for v in metrics.values()),
          "config M: non-finite SAC losses or alpha")
    # what the run wrote loads again
    work = pathlib.Path(work_dir)
    sac = bundles.calls[-1][1][0]
    sac_state = sac.load_checkpoint(work / "sac.pkl")
    check(int(sac_state.updates) > 0, "sac.pkl: a state before any update")
    buffer = ReplayBuffer(cfg.algorithm.dataset_size, (OBS_M,), (ACT_M,), obs_type=np.double,
                          action_type=np.double, reward_type=np.double)
    buffer.load(work)
    check(buffer.num_stored == cfg.algorithm.dataset_size, f"replay_buffer.npz: {buffer.num_stored} rows")
    state = wrapper.load(wrapper.init(torch.Generator().manual_seed(0)), work)
    check(state["params"]["elite"].shape == (ELITES,) and state["normalizer"].mean.dtype == torch.float64,
          "model.pkl: elites or normalizer lost")
    log = read_csv(work / "results.csv")
    check(len(log["episode_reward"]) == steps // cfg.overrides.epoch_length == len(epochs)
          and bool(np.isfinite(log["episode_reward"]).all()), f"config M: evaluations {log}")
    train_log = read_csv(work / "model_train.csv")
    check(bool(np.isfinite(train_log["model_loss"]).all()), "config M: non-finite model loss")
    # ms per environment step of the loop, SAC bundle included: the gap before
    # each step that follows neither a retraining nor an evaluation
    gaps = np.asarray(env.gap_ms[explore + 1:])
    after = np.arange(steps - 1)  # the loop's step each gap follows
    plain = (after + 1) % freq != 0
    learning = plain & (after >= freq - 1)  # a bundle of SAC updates ran before
    # one bundle under the profiler, on the run's last SAC state and buffer
    _, b_args, b_kwargs, _ = bundles.calls[-1]
    busy = profile_busy(lambda: bundles.orig(*b_args, **b_kwargs)) if device == "cuda" else None
    return {
        "num_steps": steps, "published_num_steps": M_PUBLISHED_STEPS, "exploration_steps": explore,
        "retrainings": retrainings, "total_s": total_s, "best_eval_reward": float(best),
        "eval_rewards": log["episode_reward"], "epochs": epochs,
        "sac_buffer_rows_after_first_rollout": stored[0],
        "sac_buffer_rows": stored,
        "env_step_ms_median": float(np.median(gaps[learning])),
        "env_step_ms_before_learning": float(np.median(gaps[plain & ~learning])),
        "retrain_ms": [c[0] for c in retrains.calls],
        "retrain_epochs": [int(sum(np.asarray(train_log["train_iteration"]) == i))
                           for i in range(retrainings)],
        "rollout_ms": [c[0] for c in rollouts.calls], "rollout_rows": rows,
        "sac_updates": len(bundle_ms) * n_updates,
        "sac_bundle_ms_median": float(np.median(bundle_ms)),
        "sac_updates_per_s": n_updates / (float(np.median(bundle_ms)) / 1e3),
        "sac_losses_last": {k: float(v[-1]) for k, v in metrics.items()},
        "bundle_profile": busy,
        "model_losses_first_last": [train_log["model_loss"][0], train_log["model_loss"][-1]],
    }, learner[-1]


# --------------------------------------------------------------------------- #
# Config M-HC: MBPO-HalfCheetah's shape without the environment
# --------------------------------------------------------------------------- #
# overrides/mbpo_halfcheetah.yaml: 400 rollouts a step x 250 steps between
# retrainings; SAC 512 wide, batch 256, target entropy -1, target interval 1
MHC_ROWS, MHC_HORIZONS = 100_000, (1, 5)
MHC_SAC = dict(gamma=0.99, tau=0.005, alpha=0.2, policy="Gaussian", target_update_interval=1,
               automatic_entropy_tuning=True, hidden_size=512, lr=0.0003, target_entropy=-1.0)
MHC_BATCH, MHC_UPDATES = 256, 10


def mhc_sac(device: str):
    """MBPO-HalfCheetah's SAC (obs 17, act 6 in [-1, 1]) with weights from ``SEED``."""
    from mbrl_tpu_torch.envs.spaces import Box
    from mbrl_tpu_torch.planning.sac import SAC

    sac = SAC(OBS_A, Box(-1.0, 1.0, shape=(ACT,)), device=device, **MHC_SAC)
    return sac, sac.init(torch.Generator().manual_seed(SEED + 30))


def sac_update_card_vs_cpu():
    """One SAC update at M-HC's widths on a fixed batch, the same weights and
    the same normals, on the card and on the CPU."""
    from unittest import mock

    from mbrl_tpu_torch.planning import sac as sac_mod

    rng = np.random.default_rng(SEED + 31)
    batch = (rng.standard_normal((MHC_BATCH, OBS_A)), rng.uniform(-1, 1, (MHC_BATCH, ACT)),
             rng.standard_normal((MHC_BATCH, OBS_A)), rng.standard_normal((MHC_BATCH, 1)),
             (rng.random((MHC_BATCH, 1)) > 0.05).astype(np.float64))
    draws = [rng.standard_normal((MHC_BATCH, ACT)) for _ in range(2)]
    out = {}
    for dev in ("cuda", "cpu"):
        sac, state = mhc_sac(dev)
        it = iter(draws)
        normal = lambda g, shape, device: torch.as_tensor(next(it), dtype=torch.float32, device=device)  # noqa: E731
        with mock.patch.object(sac_mod, "normal", normal):
            state, m = sac.update_parameters(
                state, tuple(torch.as_tensor(b, dtype=torch.float32, device=dev) for b in batch), None)
        leaves = [p.detach().cpu() for mod in (state.policy, state.critic, state.critic_target)
                  for p in mod.parameters()] + [state.log_alpha.detach().cpu()]
        out[dev] = ({k: float(v) for k, v in m.items()}, leaves)
    (m_d, p_d), (m_c, p_c) = out["cuda"], out["cpu"]
    loss_err = max(abs(m_d[k] - m_c[k]) / max(abs(m_c[k]), 1e-12)
                   for k in ("critic_loss", "policy_loss", "alpha_loss"))
    param_err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))
                    for a, b in zip(p_d, p_c))
    check(loss_err <= 1e-5 and param_err <= 1e-4,
          f"config M-HC: SAC update card vs CPU: losses {m_d} vs {m_c} (worst relative {loss_err}), "
          f"worst parameter error {param_err} of its leaf's largest entry")
    return {"loss_max_rel_err": loss_err, "param_max_rel_err": param_err, "losses_card": m_d,
            "losses_cpu": m_c}


def mbpo_halfcheetah_shape(device: str = "cuda"):
    """The imagined rollout at MBPO-HalfCheetah's batch: a seeded GaussianMLP
    (in 23, out 18 with the learned reward, 4 x 200 silu, E=7, 5 elites, f32,
    double-precision normalizer) and M-HC's SAC, from 100,000 rows sampled from a
    synthetic replay buffer into the device SAC buffer: rollout length 1, then
    5, ``no_termination``; then three bundles of 10 SAC updates from that
    buffer."""
    from mbrl_tpu_torch.algorithms import mbpo
    from mbrl_tpu_torch.envs import termination_fns
    from mbrl_tpu_torch.models import GaussianMLP, ModelEnv, TransitionRewardModel
    from mbrl_tpu_torch.util.device_buffer import DeviceReplayBuffer
    from mbrl_tpu_torch.util.replay_buffer import ReplayBuffer

    model = GaussianMLP(OBS_A + ACT, OBS_A + 1, LAYERS, ENSEMBLE, HID, activation="silu",
                        propagation_method="random_model", device=device)
    wrapper = TransitionRewardModel(model, target_is_delta=True, normalize=True,
                                    normalize_double_precision=True, learned_rewards=True,
                                    num_elites=ELITES)
    state = wrapper.set_elite(wrapper.init(torch.Generator().manual_seed(SEED + 32)),
                              list(range(ELITES)))
    rng = np.random.default_rng(SEED + 33)
    n = MHC_ROWS
    obs, act = rng.standard_normal((n, OBS_A)), rng.uniform(-1, 1, (n, ACT))
    next_obs = obs + 0.1 * np.tanh(obs[:, ::-1] + act.sum(1, keepdims=True))
    buffer = ReplayBuffer(n, (OBS_A,), (ACT,), obs_type=np.double, action_type=np.double,
                          reward_type=np.double, rng=np.random.default_rng(SEED + 34))
    buffer.add_batch(obs, act, next_obs, next_obs[:, 0] - 0.1 * (act**2).sum(1),
                     np.zeros(n, bool), np.zeros(n, bool))
    state = wrapper.update_normalizer_host(state, buffer.get_all())
    model_env = ModelEnv(wrapper, termination_fns.no_termination)
    sac, sac_state = mhc_sac(device)
    sac_buffer = DeviceReplayBuffer(n * sum(MHC_HORIZONS), OBS_A, ACT, device=device)
    buf_state = sac_buffer.init()
    g = torch.Generator(device=device).manual_seed(SEED + 35)
    rollout_ms = []
    for horizon in MHC_HORIZONS:
        sync(device)
        t0 = time.perf_counter()
        buf_state = mbpo.rollout_model_and_populate_sac_buffer(
            model_env, state, buffer, sac, sac_state, sac_buffer, buf_state, True, horizon, n, g)
        sync(device)
        rollout_ms.append((time.perf_counter() - t0) * 1e3)
    stored = int(buf_state.num_stored)
    check(stored == n * sum(MHC_HORIZONS), f"config M-HC: {stored} rows in the SAC buffer")
    check(bool(torch.isfinite(buf_state.next_obs[:stored]).all() and
               torch.isfinite(buf_state.reward[:stored]).all()), "config M-HC: non-finite rollout rows")
    bundle_ms = []
    for _ in range(3):
        sync(device)
        t0 = time.perf_counter()
        sac_state, m = sac.update_from_buffer(sac_state, buf_state, g, MHC_UPDATES, MHC_BATCH)
        sync(device)
        bundle_ms.append((time.perf_counter() - t0) * 1e3)
        check(all(bool(torch.isfinite(v)) for v in m.values()), f"config M-HC: SAC metrics {m}")
    return {"rows": n, "horizons": list(MHC_HORIZONS), "rollout_ms": rollout_ms,
            "rollout_ms_per_step": [t / h for t, h in zip(rollout_ms, MHC_HORIZONS)],
            "sac_buffer_rows": stored, "bundle_ms": bundle_ms,
            "sac_updates_per_s": MHC_UPDATES / (float(np.median(bundle_ms)) / 1e3)}


def mbpo_kernel_checks():
    """K3 at config M's shape: E=5 x S=16,000 (80,000 imagined rows over the 5
    elites), in 5, head 10, 4 x 200 silu, f32 and bf16."""
    from mbrl_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(SEED + 36)
    results = {}
    rows = CONFIG_M["overrides"]["effective_model_rollouts_per_step"] * CONFIG_M["overrides"]["freq_train_model"]
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        stack, _, _ = elite_stack(OBS_M + ACT_M, OBS_M + 1, dtype, g)
        x = torch.randn((ELITES, rows // ELITES, OBS_M + ACT_M), generator=g).to("cuda")
        results[("K3@M", dt_name)] = check_k3(K, x, stack, dt_name, "M")
    print("kernels at config M's shape: " + json.dumps({k[1]: v for k, v in results.items()}), flush=True)
    return results


# --------------------------------------------------------------------------- #
# The SAC policy kernel (csrc/policy_mlp.cu) at MBPO's rollout batch
# --------------------------------------------------------------------------- #
# (in, hidden, act) of the benchmark's policies: Walker2d and truncated-obs
# Humanoid at 1,024 wide, HalfCheetah at 512 (mbrl-lib's mbpo_*.yaml)
POLICY_WIDTHS = {"walker": (17, 1024, 6), "humanoid": (45, 1024, 17), "halfcheetah": (17, 512, 6)}
POLICY_ROWS = 100_000
# largest |kernel - plain| over the outputs, relative to max(1, |plain|): the
# same 3xTF32 arithmetic summed in another order (a few f32 roundings)
POLICY_TOL = 2e-6


def policy_kernel_checks():
    """The policy kernel against its plain version at 100,000 and 100,003
    rows for the three widths, and at the dispatch threshold's edge; at
    100,000 rows its time, bound, the plain version's and the library's
    (the ``nn.Linear`` forward, cuBLAS's f32 SGEMMs and PyTorch's ReLU
    passes: the route the policy took before the kernel)."""
    import torch.nn.functional as F

    from mbrl_tpu_torch.ops import kernels as K
    from mbrl_tpu_torch.planning.sac import GaussianPolicy

    def linear_forward(p, x):
        h = F.relu(p.linear2(F.relu(p.linear1(x))))
        return p.mean_linear(h), torch.clamp(p.log_std_linear(h), -20.0, 2.0)

    results = {}
    for name, (din, hidden, act) in POLICY_WIDTHS.items():
        torch.manual_seed(SEED + 40)
        p = GaussianPolicy(din, act, hidden).cuda()
        with torch.no_grad():
            for layer in p._layers():
                layer.bias.normal_(0.0, 0.1)
        pack = p.packed()
        row = {}
        for rows in (POLICY_ROWS, POLICY_ROWS + 3, K.POLICY_KERNEL_ROWS):
            x = torch.randn((rows, din), generator=torch.Generator().manual_seed(rows)).cuda()
            with torch.no_grad():
                got = K.fused_policy_mlp(x, pack)
                sync("cuda")
                ref = K.fused_policy_mlp_plain(x, pack)
                lin = linear_forward(p, x)
            err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                      for a, b in zip(got, ref))
            err_lin = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                          for a, b in zip(got, lin))
            check(err <= POLICY_TOL and err_lin <= POLICY_TOL,
                  f"policy {name} at {rows} rows: kernel vs plain {err}, vs nn.Linear {err_lin}")
            row[f"err_{rows}"], row[f"err_linear_{rows}"] = err, err_lin
        # the dispatch at the threshold's edge
        for rows, launches in ((K.POLICY_KERNEL_ROWS, 1), (K.POLICY_KERNEL_ROWS - 1, 0)):
            K.reset_launch_counts()
            with torch.no_grad():
                p(torch.zeros((rows, din), device="cuda"))
            check(K.launch_counts()["fused_policy_mlp"] == launches,
                  f"policy {name}: {rows} rows gave {K.launch_counts()}")
        x = torch.randn((POLICY_ROWS, din), generator=torch.Generator().manual_seed(0)).cuda()
        with torch.no_grad():
            row["ms"] = time_ms(lambda: K.fused_policy_mlp(x, pack), 20)
            row["plain_ms"] = time_ms(lambda: K.fused_policy_mlp_plain(x, pack), 5)
            row["library_ms"] = time_ms(lambda: linear_forward(p, x), 20)
        macs = din * hidden + hidden * hidden + hidden * 2 * act
        nbytes = 4 * (POLICY_ROWS * (din + 2 * act) + macs + 2 * hidden + 2 * act)
        row["bound_ms"], row["bound_by"] = bound(2.0 * POLICY_ROWS * macs, nbytes, False)
        row["share"] = row["bound_ms"] / row["ms"]
        results[name] = row
    print("policy kernel (100,000 rows): " + json.dumps(results), flush=True)
    return results


# --------------------------------------------------------------------------- #
# K3 in the batch's order with the Gaussian head finished (mbrl_ensemble_mlp_head)
# --------------------------------------------------------------------------- #
# (model in, out) of the benchmark's models: MBPO-Walker2d and truncated-obs
# Humanoid, 4 x 200 silu, 5 elites of 7, out = obs + reward
K3_HEAD_WIDTHS = {"walker": (23, 18), "humanoid": (62, 46)}
K3_HEAD_ROWS = (100_000, 100_005)  # 20,000 rows an elite; 20,001, a ragged last tile
# largest |kernel - plain| over the outputs, relative to max(1, |plain|): 3xTF32
# products against full f32 ones, the same head arithmetic
K3_HEAD_TOL = 1e-6


def k3_head_checks():
    """K3 on its two-tile route reading its rows through a permutation and
    finishing the Gaussian head (``fused_ensemble_mlp(..., perm=,
    logvar_bounds=, noise=)``) against its plain version, at both widths and
    both row counts, with and without noise; at 100,000 rows the times of the
    raw K3, of K3 with the head, and of the PyTorch composition the head
    replaces (gather, raw K3, bound, reshape, inverse gather, draw) on
    ``GaussianMLP``'s own functions."""
    from mbrl_tpu_torch.models import GaussianMLP
    from mbrl_tpu_torch.ops import kernels as K

    results = {}
    for name, (din, out) in K3_HEAD_WIDTHS.items():
        model = GaussianMLP(din, out, LAYERS, ENSEMBLE, HID, activation="silu",
                            propagation_method="random_model", device="cuda")
        g = torch.Generator(device="cuda").manual_seed(SEED + 41)
        params = model.init(g)
        for layer in params["layers"] + [params["head"]]:
            layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=g, device="cuda")
        params = model.set_elite(params, list(range(ELITES)))
        cached = model.packed(params)
        bounds = (cached.view["max_logvar"], cached.view["min_logvar"])
        row = {}
        for rows in K3_HEAD_ROWS:
            x = torch.randn((rows, din), generator=g, device="cuda")
            perm = torch.randperm(rows, generator=g, device="cuda")
            noise = torch.randn((rows, out), generator=g, device="cuda")
            xs = x.reshape(ELITES, rows // ELITES, din)
            for sample in (True, False):
                z = noise if sample else None
                K.reset_launch_counts()
                got = K.fused_ensemble_mlp(xs, cached.stack, tiles=cached.tiles, perm=perm,
                                           logvar_bounds=bounds, noise=z)
                sync("cuda")
                check(K.launch_counts()["fused_ensemble_mlp.fused_head"] == 1,
                      f"K3 head {name}: {K.launch_counts()}")
                ref = K.fused_ensemble_mlp_head_plain(xs, cached.stack, perm, *bounds, z)
                err = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
                          for a, b in zip(got, ref) if b is not None)
                check(err <= K3_HEAD_TOL,
                      f"K3 head {name} at {rows} rows (noise {sample}): gap {err}")
                row[f"gap_{rows}_{'drawn' if sample else 'mean'}"] = err
            if rows != K3_HEAD_ROWS[0]:
                continue
            inv = torch.argsort(perm)
            h = model._permute_rows(x, perm, ELITES)

            def glue():
                hp = model._permute_rows(x, perm, ELITES)
                raw = K.fused_ensemble_mlp(hp, cached.stack, tiles=cached.tiles)
                mean, lv = model._bound(cached.view, raw)
                mean, lv = model._unpermute_rows(mean.reshape(rows, -1), lv.reshape(rows, -1),
                                                 perm, inv)
                return mean + torch.exp(0.5 * lv) * noise

            def fused():
                return K.fused_ensemble_mlp(xs, cached.stack, tiles=cached.tiles, perm=perm,
                                            logvar_bounds=bounds, noise=noise)

            row["raw_ms"] = time_graph_ms(
                lambda: K.fused_ensemble_mlp(h, cached.stack, tiles=cached.tiles), 20)
            # the same products, then PyTorch's head on the card: the epilogue's arithmetic alone
            row["glue_gap"] = float(((fused()[0] - glue()).abs() / glue().abs().clamp(min=1.0)).max())
            check(row["glue_gap"] <= K3_HEAD_TOL, f"K3 head {name}: against the glue {row['glue_gap']}")
            row["head_ms"] = time_graph_ms(fused, 20)
            ordered = torch.arange(rows, device="cuda")  # rows read and written in order
            row["head_in_order_ms"] = time_graph_ms(
                lambda: K.fused_ensemble_mlp(xs, cached.stack, tiles=cached.tiles, perm=ordered,
                                             logvar_bounds=bounds, noise=noise), 20)
            row["glue_ms"] = time_graph_ms(glue, 20)
            row["head_eager_ms"] = time_ms(fused, 20)
            row["glue_eager_ms"] = time_ms(glue, 20)
            row["plain_ms"] = time_ms(
                lambda: K.fused_ensemble_mlp_head_plain(xs, cached.stack, perm, *bounds, noise), 5)
            flops = 2.0 * rows * macs_per_row(cached.stack.dims)
            nbytes = stack_bytes(cached.stack) + 4.0 * rows * (din + cached.stack.dims[-1])
            row["bound_ms"], row["bound_by"] = bound(flops, nbytes, False)
        results[name] = row
    print("K3 with the Gaussian head (two-tile route): " + json.dumps(results), flush=True)
    return results


# --------------------------------------------------------------------------- #
# Config PN: PlaNet at dynamics_model/planet.yaml's full width
# --------------------------------------------------------------------------- #
# the cuts: two episodes (the first a test episode, the second with
# exploration noise) of the published 1,000, and a replay buffer of 2,000 rows,
# which holds the 1,750 the run collects (the published 1,000,000 pixel rows
# would take ~24.6 GB of host memory)
PN_EPISODES, PN_DATASET_SIZE = 2, 2000
PN_PUBLISHED = {"num_episodes": 1000, "dataset_size": 1_000_000}
ACT_PN = 6
# the fixed card-vs-CPU batch, and its tolerance (relative to the largest
# entry of each compared array): full float32 on both sides, differing by
# summation order only; TF32 would miss it (its error is printed beside)
PN_CHECK_B, PN_CHECK_L, PN_TOL = 2, 8, 1e-4
_CEM_PN = {
    "_target_": "mbrl_tpu_torch.planning.CEMOptimizer",
    "num_iterations": 10, "elite_ratio": 0.1, "population_size": 1000, "alpha": 0.0,
    "lower_bound": "???", "upper_bound": "???", "return_mean_elites": True,
    "clipped_normal": True,
}
# examples/conf/main.yaml with algorithm=planet, dynamics_model=planet,
# overrides=planet_cheetah_run, interpolations resolved; tests/test_torch_config.py
# holds it equal to the loaded YAML tree apart from the two cuts
CONFIG_PN = {
    "algorithm": {
        "name": "planet",
        "agent": {
            "_target_": "mbrl_tpu_torch.planning.TrajectoryOptimizerAgent",
            "action_lb": "???", "action_ub": "???", "planning_horizon": 12,
            "optimizer": copy.deepcopy(_CEM_PN), "replan_freq": 1, "keep_last_solution": False,
            "verbose": False,
        },
        "num_initial_trajectories": 5, "action_noise_std": 0.3, "test_frequency": 25,
        "num_episodes": PN_EPISODES, "dataset_size": PN_DATASET_SIZE,
    },
    "dynamics_model": {
        "_target_": "mbrl_tpu_torch.models.PlaNetModel",
        "obs_shape": [3, 64, 64], "obs_encoding_size": 1024,
        "encoder_config": [[3, 32, 4, 2], [32, 64, 4, 2], [64, 128, 4, 2], [128, 256, 4, 2]],
        "decoder_config": [[1024, 1, 1], [[1024, 128, 5, 2], [128, 64, 5, 2], [64, 32, 6, 2],
                                          [32, 3, 6, 2]]],
        "action_size": "???", "hidden_size_fcs": 200, "belief_size": 200, "latent_state_size": 30,
        "min_std": 0.1, "free_nats": 3, "kl_scale": 1.0, "grad_clip_norm": 1000.0,
    },
    "overrides": {
        "env": "dmcontrol___cheetah--run",
        "env_cfg": {
            "_target_": "mbrl_tpu_torch.util.dmcontrol_wrapper.make", "domain_name": "cheetah",
            "task_name": "run", "seed": 0, "visualize_reward": False, "from_pixels": True,
            "height": 64, "width": 64, "frame_skip": 4, "bit_depth": 5,
        },
        "term_fn": "no_termination", "learned_rewards": True, "trial_length": 250,
        "action_noise_std": 0.3, "num_grad_updates": 100, "sequence_length": 50,
        "batch_size": 50, "free_nats": 3, "kl_scale": 1.0, "planning_horizon": 12,
        "cem_num_iters": 10, "cem_elite_ratio": 0.1, "cem_population_size": 1000,
        "cem_alpha": 0.0, "cem_clipped_normal": True,
    },
    "action_optimizer": copy.deepcopy(_CEM_PN),
    "parallel": {"enable": False},
    "seed": 0, "log_frequency_agent": 1000, "save_video": False, "debug_mode": False,
    "experiment": "default", "root_dir": "./exp",
}


class PixelCheetah:
    """A numpy stand-in for dm_control's cheetah-run as planet_cheetah_run.yaml
    sees it (the card's machine has no dm_control): uint8 (3, 64, 64) frames
    at 5 bits a channel, rendered from a small state (six joint angles and a
    forward position), six actions in [-1, 1], a reward from the forward
    speed. A test fixture of this script, not a part of the package."""

    def __init__(self, seed: int = SEED, size: int = 64, bit_depth: int = 5):
        from mbrl_tpu_torch.envs.spaces import Box

        self.observation_space = Box(0, 255, shape=(3, size, size), dtype=np.uint8)
        self.action_space = Box(-1.0, 1.0, shape=(ACT_PN,), dtype=np.float32, seed=seed)
        self._rng = np.random.default_rng(seed)
        self._yy, self._xx = np.mgrid[0:size, 0:size]
        self._size, self._ratio = size, 2 ** (8 - bit_depth)

    def reset(self, seed=None, options=None):
        self.q, self.qd = self._rng.uniform(-0.1, 0.1, ACT_PN), np.zeros(ACT_PN)
        self.x, self.xd = 0.0, 0.0
        return self._render(), {}

    def step(self, action):
        a = np.clip(np.asarray(action, np.float64), -1.0, 1.0)
        self.qd = 0.9 * self.qd + 0.3 * a - 0.05 * np.sin(self.q)
        self.q = self.q + 0.1 * self.qd
        # the back leg pushes, the front leg pulls
        self.xd = 0.9 * self.xd + 0.1 * float(np.sum(self.qd[:3] * np.cos(self.q[:3]))
                                                - np.sum(self.qd[3:] * np.cos(self.q[3:])))
        self.x += 0.1 * self.xd
        reward = float(np.clip(self.xd, 0.0, 1.0)) - 0.01 * float(np.sum(a * a))
        return self._render(), reward, False, False, {}

    def _render(self) -> np.ndarray:
        s = self._size
        img = np.full((3, s, s), 60, np.float64)
        img[1, 3 * s // 4:] = 120  # the ground
        img[2] += 40 * (((self._xx + int(8 * self.x)) % 16) < 8)  # stripes that scroll with x
        for leg, hip in ((0, s // 3), (1, 2 * s // 3)):
            y, x = s / 2, float(hip)
            for j in range(3):  # a chain of three joints, one blob each
                angle = self.q[3 * leg + j] + j * 0.4
                y, x = y + 6 * np.cos(angle), x + 6 * np.sin(angle)
                blob = (self._yy - y) ** 2 + (self._xx - x) ** 2 < 9
                img[:, blob] = np.array([200, 80 + 40 * j, 255 - 100 * leg])[:, None]
        img = img.astype(np.uint8)
        return (img // self._ratio) * self._ratio


def _stamp(device: str):
    """A point on the device's timeline (a recorded CUDA event), or the host
    clock on the CPU, where every op has finished when it returns."""
    if device == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _between_ms(a, b) -> float:
    """ms between two stamps (CUDA events once the device has passed both)."""
    return (b - a) * 1e3 if isinstance(a, float) else a.elapsed_time(b)


def planet_config_pn(device: str = "cuda", config=None):
    """``planet.train`` on :class:`PixelCheetah` with ``CONFIG_PN``. Returns the
    run's numbers and its work directory (the caller removes it)."""
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_planet_")
    try:
        return _planet_config_pn(device, config, work_dir), work_dir
    except BaseException:
        shutil.rmtree(work_dir, ignore_errors=True)
        raise


def _planet_config_pn(device, config, work_dir):
    import contextlib
    import io
    from unittest import mock

    from mbrl_tpu_torch.algorithms import planet
    from mbrl_tpu_torch.config import Config
    from mbrl_tpu_torch.models import ModelTrainer, PlaNetModel
    from mbrl_tpu_torch.planning import TrajectoryOptimizerAgent

    cfg = Config(copy.deepcopy(CONFIG_PN if config is None else config))
    env = RecordingEnv(PixelCheetah())
    acts = _Timed(TrajectoryOptimizerAgent, "act", device)
    posteriors = _Timed(PlaNetModel, "update_posterior", device)
    trainings = _Timed(ModelTrainer, "train_device_sequences", device)
    # each update's start on the device's timeline, and its loss components
    starts, calls, metas = [], [], []
    loss = ModelTrainer._loss

    def timed_loss(self, work, batch, generator, **kw):
        starts.append(_stamp(device))
        out = loss(self, work, batch, generator, **kw)
        metas.append({k: v.detach() for k, v in out[1].items()})
        return out

    def train(self, *a, **kw):
        first = len(starts)
        out = trainings(self, *a, **kw)
        calls.append(starts[first:] + [_stamp(device)])
        return out

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(TrajectoryOptimizerAgent, "act", lambda s, *a, **k: acts(s, *a, **k)), \
            mock.patch.object(PlaNetModel, "update_posterior",
                              lambda s, *a, **k: posteriors(s, *a, **k)), \
            mock.patch.object(ModelTrainer, "train_device_sequences", train), \
            mock.patch.object(ModelTrainer, "_loss", timed_loss), \
            contextlib.redirect_stdout(io.StringIO()):
        mean_reward = planet.train(env, cfg, silent=False, work_dir=work_dir, device=device)
        sync(device)
        total_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None

    episodes, trial = cfg.algorithm.num_episodes, cfg.overrides.trial_length
    updates = cfg.overrides.num_grad_updates
    check(len(trainings.calls) == episodes and len(starts) == episodes * updates,
          f"config PN: {len(trainings.calls)} trainings, {len(starts)} updates")
    check(len(acts.calls) == len(posteriors.calls) == episodes * trial,
          f"config PN: {len(acts.calls)} acts, {len(posteriors.calls)} posterior updates")
    taken = np.asarray(env.actions[cfg.algorithm.num_initial_trajectories * trial:])
    check(taken.shape == (episodes * trial, ACT_PN) and bool(np.isfinite(taken).all())
          and bool((np.abs(taken) <= 1.0).all()), "config PN: actions not finite or out of bounds")
    update_ms = [_between_ms(c[i], c[i + 1]) for c in calls for i in range(len(c) - 1)]
    host = {k: torch.stack([m[k] for m in metas]).cpu().numpy() for k in metas[0]}
    check(all(bool(np.isfinite(v).all()) for v in host.values()), "config PN: non-finite losses")
    work = pathlib.Path(work_dir)
    for name in ("metrics", "results", "model_train"):
        log = read_csv(work / f"{name}.csv")
        check(all(bool(np.isfinite(v).all()) for v in log.values()), f"config PN: {name}.csv {log}")
    model = trainings.calls[-1][1][0].model
    state = model.load(model.init(torch.Generator().manual_seed(0)), work)
    final = trainings.calls[-1][3][0]["params"]
    check(bool(torch.equal(state["params"]["belief_gru"]["w_hh"], final["belief_gru"]["w_hh"])),
          "planet.pkl: not the last training's params")

    out = {
        "episodes": episodes, "published": PN_PUBLISHED, "updates": len(starts),
        "planned_steps": len(acts.calls), "total_s": total_s, "mean_episode_reward": float(mean_reward),
        "episode_rewards": env.episode_rewards[cfg.algorithm.num_initial_trajectories:],
        "update_ms_median": float(np.median(update_ms)),
        "update_ms_p90": float(np.percentile(update_ms, 90)),
        "train_call_ms": [c[0] for c in trainings.calls],
        "act_ms_median": float(np.median([c[0] for c in acts.calls])),
        "act_ms_p90": float(np.percentile([c[0] for c in acts.calls], 90)),
        "posterior_ms_median": float(np.median([c[0] for c in posteriors.calls])),
        "max_memory_allocated_gb": peak_gb,
        "losses_first": {k: float(v[0]) for k, v in host.items()},
        "losses_last": {k: float(v[-1]) for k, v in host.items()},
    }
    if device == "cuda":
        trainer, t_state, dataset, t_starts = trainings.calls[-1][1][:4]
        kw = {**trainings.calls[-1][2], "num_updates": 1, "batch_callback": None}
        out["update_profile"] = profile_busy(lambda: trainings.orig(trainer, t_state, dataset,
                                                                    t_starts, **kw))
        agent, obs = acts.calls[-1][1][:2]
        out["act_profile"] = profile_busy(lambda: acts.orig(agent, obs))
        out["noise_draws"] = planet_noise_draws(model, agent)
    return out


def planet_noise_draws(model, agent, reps: int = 5):
    """What one plan's prior normals cost (10 CEM iterations x 12 steps of
    (1,000, 30)): drawn per step from the agent's host generator and copied
    to the card (120 draws), against PlaNetModel.prepare_rollout's one draw of
    (12, 1,000, 30) a rollout on the card (10 draws). ms per plan."""
    from mbrl_tpu_torch.device import randn

    optimizer = agent.optimizer.optimizer
    iters, pop = optimizer.num_iterations, optimizer.population_size
    horizon = agent.optimizer.horizon
    ms_state = {"latent": torch.zeros((pop, model.latent_state_size), device="cuda")}
    g = torch.Generator().manual_seed(SEED)

    def host():
        for _ in range(iters * horizon):
            randn(g, (pop, model.latent_state_size), "cuda")

    def card():
        for _ in range(iters):
            model.prepare_rollout(None, ms_state, horizon, g)

    return {"host_per_step_ms": time_ms(host, reps), "card_per_rollout_ms": time_ms(card, reps),
            "draws": [iters * horizon, iters]}


def planet_card_vs_cpu():
    """PlanetModel at CONFIG_PN's width on one fixed batch (B = PN_CHECK_B,
    L = PN_CHECK_L, seeded pixels, actions, rewards and normals), card against
    CPU: the deterministic eval_score and its components, and the loss with
    fixed normals and its gradient, in full float32; then the eval_score that
    TF32 (cuDNN's default on this card) would give, for the record."""
    from mbrl_tpu_torch.models import PlaNetModel
    from mbrl_tpu_torch.ops.tree import tree_leaves_with_path, tree_map
    from mbrl_tpu_torch.types import TransitionBatch

    kw = {k: v for k, v in CONFIG_PN["dynamics_model"].items() if k != "_target_"}
    kw["action_size"] = ACT_PN
    b, length, s = PN_CHECK_B, PN_CHECK_L, kw["latent_state_size"]
    rng = np.random.default_rng(SEED + 40)
    obs = rng.integers(0, 256, (b, length, *kw["obs_shape"])).astype(np.uint8)
    act = rng.uniform(-1, 1, (b, length, ACT_PN)).astype(np.float32)
    rew = rng.standard_normal((b, length)).astype(np.float32)
    flags = np.zeros((b, length), bool)
    post, prior = rng.standard_normal((2, b, length - 1, s)).astype(np.float32)
    cpu_state = PlaNetModel(**kw, device="cpu").init(torch.Generator().manual_seed(SEED + 41))

    def run(model):
        dev = model.device
        state = tree_map(lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t, cpu_state)
        batch = TransitionBatch(*(torch.as_tensor(x, device=dev)
                                  for x in (obs, act, obs, rew, flags, flags)))
        with torch.no_grad():
            score, meta = model.eval_score(state, batch)
        params = tree_map(lambda t: t.detach().clone().requires_grad_(True), state["params"])
        loss, _ = model.loss({**state, "params": params}, batch,
                             post_noise=torch.as_tensor(post, device=dev),
                             prior_noise=torch.as_tensor(prior, device=dev))
        with model.precision():
            loss.backward()
        grads = [t.grad.cpu() for _, t in tree_leaves_with_path(params)]
        parts = torch.cat([score.reshape(-1), *(v.reshape(1) for v in meta.values())])
        return parts.cpu(), loss.detach().cpu(), grads

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    cudnn_tf32, matmul = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    card, cpu = run(PlaNetModel(**kw, device="cuda")), run(PlaNetModel(**kw, device="cpu"))
    check((torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
          == (cudnn_tf32, matmul), "config PN: PlaNet left the TF32 flags changed")
    out = {"batch": [b, length], "tol": PN_TOL, "eval_score_rel_err": rel(card[0], cpu[0]),
           "loss_card": float(card[1]), "loss_cpu": float(cpu[1]),
           "loss_rel_err": rel(card[1], cpu[1]),
           "grad_max_rel_err": max(rel(a, b) for a, b in zip(card[2], cpu[2]))}
    check(max(out["eval_score_rel_err"], out["loss_rel_err"], out["grad_max_rel_err"]) <= PN_TOL,
          f"config PN card vs CPU: {out}")
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        tf32 = run(PlaNetModel(**kw, matmul_precision="default", device="cuda"))
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(matmul)
    out["tf32_eval_score_rel_err"] = rel(tf32[0], cpu[0])
    out["tf32_grad_max_rel_err"] = max(rel(a, b) for a, b in zip(tf32[2], cpu[2]))
    return out


# --------------------------------------------------------------------------- #
# Config CL: the closed-loop MPC driver at full width
# --------------------------------------------------------------------------- #
CL_STEPS = 20


class StepClock:
    """A ModelEnv whose ``step`` waits for the card and records the host time
    at which it returned: given to ``ClosedLoopDriver`` as its act env, the
    gaps are the closed loop's steps (a plan, then a model step)."""

    def __init__(self, env):
        self.env = env
        self.dynamics_model = env.dynamics_model
        self.stamps = []

    def reset(self, *a, **kw):
        out = self.env.reset(*a, **kw)
        torch.cuda.synchronize()
        self.stamps = [time.perf_counter()]
        return out

    def step(self, *a, **kw):
        out = self.env.step(*a, **kw)
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        return out


def closed_loop_setup(name: str, device: str = "cuda", hid: int = HID):
    """Config A's or B's model and planner (CEM 5 x ``POP`` x ``PARTICLES``
    particles x ``HORIZON``, elite ratio 0.16, alpha 0.12, mean of the elites)
    in a ``ClosedLoopDriver`` that plans and acts in that model; the first
    observation, seeded."""
    from mbrl_tpu_torch.planning import CEMOptimizer, ClosedLoopDriver

    env, state, obs_dim = build_config(name, device, torch.Generator().manual_seed(SEED + 30),
                                       hid=hid)
    bounds = np.tile(-np.ones(ACT, np.float32), (HORIZON, 1)), np.tile(np.ones(ACT, np.float32),
                                                                       (HORIZON, 1))
    cem = CEMOptimizer(5, 0.16, POP, *bounds, alpha=0.12, return_mean_elites=True, device=device)
    obs0 = (0.1 * np.random.default_rng(SEED + 31).standard_normal(obs_dim)).astype(np.float32)
    return ClosedLoopDriver(env, cem, HORIZON, ACT, PARTICLES), env, state, obs0


def hand_loop(driver, state, obs0, generator, steps: int):
    """The closed loop of ``driver`` written out with its optimizer's
    ``optimize`` and its model environment's ``ModelEnv.step``: shift the
    solution, plan, step row 0's action on rows padded to the elite count."""
    opt, env = driver.optimizer, driver.plan_env
    horizon, act_dim = driver.horizon, driver.act_dim
    rows = int(state["params"]["elite"].shape[0])
    obs_rows = torch.as_tensor(obs0, device=opt.device).expand(rows, -1).contiguous()
    env_state = env.reset(state, obs_rows, generator)
    solution = torch.zeros((horizon, act_dim), device=opt.device)
    opt_state, out = opt.init_state(), []

    def objective(population, st, o, g):
        return env.evaluate_action_sequences(st, population, o, g,
                                             num_particles=driver.num_particles)

    for _ in range(steps):
        x0 = torch.cat([solution[1:], torch.zeros((1, act_dim), device=opt.device)])
        solution, opt_state = opt.optimize(objective, x0, generator, opt_state,
                                           obj_args=(state, obs_rows[0], generator))
        next_obs, reward, term, env_state = env.step(state, solution[0].expand(rows, act_dim),
                                                     env_state, generator,
                                                     sample=driver.sample_env_step)
        out.append((obs_rows[0], solution[0], reward.reshape(-1)[0], term.reshape(-1)[0]))
        obs_rows = next_obs
    return [torch.stack(x) for x in zip(*out)]


def closed_loop_config(name: str, device: str = "cuda", steps: int = CL_STEPS):
    """``steps`` closed-loop MPC steps of config A or B (the counted run): ms a
    step, actions finite and in bounds."""
    driver, env, state, obs0 = closed_loop_setup(name, device)
    sync(device)
    t0 = time.perf_counter()
    obs, actions, rewards, terms = driver.run(state, obs0, torch.Generator().manual_seed(SEED + 32),
                                              steps)
    sync(device)
    total_ms = (time.perf_counter() - t0) * 1e3
    check(tuple(obs.shape) == (steps, len(obs0)) and tuple(actions.shape) == (steps, ACT)
          and tuple(rewards.shape) == (steps,) and tuple(terms.shape) == (steps,),
          f"config CL-{name}: bad shapes {obs.shape} {actions.shape} {rewards.shape}")
    check(bool(torch.isfinite(actions).all() and (actions.abs() <= 1 + 1e-6).all()
               and torch.isfinite(obs).all() and torch.isfinite(rewards).all()),
          f"config CL-{name}: actions not finite or out of bounds, or non-finite observations")
    check(float((obs[0].cpu() - torch.as_tensor(obs0)).abs().max()) == 0.0,
          f"config CL-{name}: the trajectory does not start at obs0")
    return {"steps": steps, "run_ms": total_ms, "ms_per_step_mean": total_ms / steps,
            "rewards": rewards.cpu().tolist()}


def closed_loop_checks(name: str, steps: int = CL_STEPS):
    """Config A or B's closed loop beside the counted run: per-step times (each
    step waited for), the card's busy share of a run under the profiler, the
    driver against the hand-written loop from equal seeds, and the agent's
    ``act`` at the same config."""
    driver, env, state, obs0 = closed_loop_setup(name)
    clock = StepClock(env)
    driver.act_env = clock
    driver.run(state, obs0, torch.Generator().manual_seed(SEED + 33), steps)
    step_ms = np.diff(clock.stamps) * 1e3
    driver.act_env = env
    busy = profile_busy(lambda: driver.run(state, obs0, torch.Generator().manual_seed(SEED + 34),
                                           steps), PORT_KERNELS)
    got = driver.run(state, obs0, torch.Generator().manual_seed(SEED + 35), steps)
    want = hand_loop(driver, state, obs0, torch.Generator().manual_seed(SEED + 35), steps)
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    check(err <= 1e-6, f"config CL-{name}: the driver differs from the hand-written loop by {err}")
    act_ms = plan_config(name, acts=4)[1:]
    return {"step_ms_median": float(np.median(step_ms)), "step_ms_p90": float(np.percentile(step_ms, 90)),
            "step_ms": step_ms.tolist(), "driver_vs_hand_loop_max_abs_err": err,
            "agent_act_ms": act_ms, "agent_act_ms_median": float(np.median(act_ms)),
            "profile": busy}


class ToyIntegrator:
    """tests/test_closed_loop.py's toy system on the card: s' = s + 0.2 a,
    reward -(s' - 1)^2, optimum s = 1."""

    class _Model:
        model = None

    dynamics_model = _Model()

    def reset(self, state, obs_rows, generator):
        return {"s": obs_rows}

    def step(self, state, action, env_state, generator, sample=True):
        s = env_state["s"] + 0.2 * action
        r = -torch.square(s - 1.0).sum(dim=-1, keepdim=True)
        return s, r, torch.zeros_like(r, dtype=torch.bool), {"s": s}

    def evaluate_action_sequences(self, state, population, obs, generator, num_particles=1):
        s = obs.expand(population.shape[0], -1)
        total = torch.zeros(population.shape[0], device=population.device)
        for t in range(population.shape[1]):
            s = s + 0.2 * population[:, t]
            total = total - torch.square(s - 1.0).sum(dim=-1)
        return total


def closed_loop_integrator(device: str = "cuda", horizon: int = 5, steps: int = 25):
    """CEM, iCEM and MPPI each drive the toy integrator to its optimum."""
    from mbrl_tpu_torch.planning import (
        CEMOptimizer, ClosedLoopDriver, ICEMOptimizer, MPPIOptimizer,
    )

    bounds = dict(lower_bound=[[-1.0]] * horizon, upper_bound=[[1.0]] * horizon, device=device)
    optimizers = {
        "cem": CEMOptimizer(3, 0.2, 40, alpha=0.1, return_mean_elites=True, **bounds),
        "icem": ICEMOptimizer(3, 0.2, 40, population_decay_factor=1.3, colored_noise_exponent=2.0,
                              keep_elite_frac=0.5, alpha=0.1, **bounds),
        "mppi": MPPIOptimizer(4, 50, gamma=1.0, sigma=0.5, beta=0.7, **bounds),
    }
    final = {}
    for name, opt in optimizers.items():
        driver = ClosedLoopDriver(ToyIntegrator(), opt, horizon=horizon, act_dim=1, num_particles=1)
        obs, actions, _, _ = driver.run({"params": {}}, np.zeros(1, np.float32),
                                        torch.Generator().manual_seed(SEED), steps)
        final[name] = float(obs[-1, 0])
        check(obs.device.type == device and final[name] > 0.7 and bool(torch.isfinite(actions).all()),
              f"closed loop {name}: the integrator ends at {final[name]}, not near its optimum 1")
    return final


# --------------------------------------------------------------------------- #
# Config BE: BasicEnsemble in the PETS loop
# --------------------------------------------------------------------------- #
# examples/conf/main.yaml with algorithm=pets, overrides=pets_cartpole,
# dynamics_model=basic_ensemble, action_optimizer=cem, parallel=none,
# interpolations resolved; tests/test_torch_config.py holds it equal to the
# loaded YAML tree apart from overrides.num_steps
CONFIG_BE = {
    **copy.deepcopy(CONFIG_E),
    "dynamics_model": {
        "_target_": "mbrl_tpu_torch.models.BasicEnsemble",
        "ensemble_size": 5, "propagation_method": "fixed_model",
        "member_cfg": {
            "_target_": "mbrl_tpu_torch.models.GaussianMLP",
            "num_layers": 4, "in_size": "???", "out_size": "???", "ensemble_size": 1,
            "hid_size": 200, "deterministic": False, "learn_logvar_bounds": False,
            "activation": "silu",
        },
    },
}
# card vs CPU in full float32, relative to the largest magnitude: forward,
# propagation, loss and the whole gradient; and each gradient leaf on its own
BE_TOL, BE_LEAF_TOL = 1e-5, 1e-4


def basic_ensemble_card_vs_cpu(wrapper, state, rows):
    """The trained ensemble's forward (all members), ``fixed_model``
    propagation, loss and gradient on the card against the CPU, on the
    converted (copied) weights and the first ``rows``-row batch of its own
    buffer, bootstrapped 5 x 64."""
    from mbrl_tpu_torch.config import Config, create_one_dim_tr_model
    from mbrl_tpu_torch.models.trainer import ModelTrainer, _Work
    from mbrl_tpu_torch.ops.tree import tree_map

    def on(device):
        return tree_map(lambda t: t.detach().to(device) if isinstance(t, torch.Tensor) else t, state)

    idx = np.random.default_rng(SEED + 36).integers(0, len(rows), (5, 64))
    out = {}
    for device in ("cuda", "cpu"):
        w = create_one_dim_tr_model(Config(copy.deepcopy(CONFIG_BE)), (OBS_E,), (ACT_E,), device=device)
        st = on(device)
        batch = rows[idx.reshape(-1)].map(lambda x: x.reshape((5, 64) + x.shape[1:])).to(device)
        model_in, _ = w.process_batch(st, rows[: 64].to(device))
        with torch.no_grad():
            mean, logvar = w.model.forward(st["params"], model_in)
            prop = st["params"]["elite"].new_tensor(np.arange(64) % 5)
            pm, _ = w.model.forward_propagated(st["params"], model_in, propagation_indices=prop)
        work = _Work(ModelTrainer(w), st)
        loss, _ = w.loss(work.state(), batch)
        loss.backward()
        out[device] = [mean.cpu(), logvar.cpu(), pm.cpu(), loss.detach().cpu()[None],
                       *(leaf.grad.cpu() for leaf in work.leaves)]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    errs = [rel(a, b) for a, b in zip(out["cuda"], out["cpu"])]
    # the gradient as one vector (every leaf), relative to its largest entry;
    # each leaf against its own largest entry is held at 1e-4, as config T's is
    grads = [torch.cat([g.reshape(-1) for g in out[d][4:]]) for d in ("cuda", "cpu")]
    numbers = {"forward_rel_err": max(errs[:2]), "fixed_model_rel_err": errs[2],
               "loss_rel_err": errs[3], "grad_rel_err": rel(*grads),
               "grad_leaf_max_rel_err": max(errs[4:]),
               "loss_card": float(out["cuda"][3]), "loss_cpu": float(out["cpu"][3]),
               "tol": BE_TOL, "leaf_tol": BE_LEAF_TOL}
    check(max(errs[:4] + [numbers["grad_rel_err"]]) <= BE_TOL
          and numbers["grad_leaf_max_rel_err"] <= BE_LEAF_TOL, f"config BE card vs CPU: {numbers}")
    return numbers


# --------------------------------------------------------------------------- #
# Config DG: the diagnostics, load_agent, video, profiling and the tutorials,
# on the run directories that configs E, M and PN saved
# --------------------------------------------------------------------------- #
# the JAX package's CLI defaults (diagnostics/visualize_model_preds.py:125-128,
# finetune_model_with_controller.py:106-113, planet_visualizer.py's CLI and its
# planner :43-46). The cuts: FineTuner's steps_to_collect 10,000 -> 200 and
# num_epochs 50 -> 5; tutorial_pets' num_steps 2,000 -> 400; the 1-D fit's
# epochs 500 -> 200 (where its tests hold it), to keep the script's time
DG_VIS = {"lookahead": 25, "num_model_samples": 5, "num_steps": 50}
DG_FT = {"batch_size": 256, "val_ratio": 0.1, "num_epochs": 5, "patience": 10,
         "steps_to_collect": 200}
DG_FT_PUBLISHED = {"num_epochs": 50, "steps_to_collect": 10_000}
DG_PV = {"start_step": 0, "lookahead": 50, "seed": 1234, "num_iterations": 10,
         "population_size": 1000, "planning_horizon": 12}
DG_TDC = {"horizon": 15, "population_size": 100, "num_iterations": 5, "num_workers": 4}
DG_TUT_STEPS, DG_TUT_PUBLISHED = 400, 2000
DG_FIT_EPOCHS, DG_FIT_PUBLISHED = 200, 500
DG_WARM_ACTS = 5
# the fixed observation config E's reloaded and hand-built agents act on
DG_OBS = np.array([0.02, -0.01, 0.03, 0.01], np.float32)
# tutorial_pets' model and planner: 5 members (4 elites) of 3x128 silu, in 5,
# out 4; CEM 350 x 20 particles x horizon 15, 5 iterations
TUT_MEMBERS, TUT_ELITES, TUT_LAYERS, TUT_HID = 5, 4, 3, 128
# thresholds of the tutorials' checks: tests/test_optimizers.py's for
# Rosenbrock (optimum 0); tests/test_torch_tutorials.py's for the 1-D fit
ROSENBROCK_THRESHOLD, FIT_RMSE = -0.1, 0.25


class RenderedCartpole:
    """Wraps the port's cartpole (bare or in its TimeLimit) with a ``render``
    that draws the cart and the pole into a 64x96 RGB frame (the package's
    cartpole renders nothing, as the JAX package's does). A test fixture of
    this script, not a part of the package."""

    def __init__(self, env):
        self.env = env
        self.observation_space, self.action_space = env.observation_space, env.action_space

    def reset(self, **kw):
        return self.env.reset(**kw)

    def step(self, action):
        return self.env.step(action)

    def render(self) -> np.ndarray:
        x, _, theta, _ = getattr(self.env, "unwrapped", self.env).state
        frame = np.full((64, 96, 3), 255, np.uint8)
        frame[48:50] = 80  # the track
        cx = int(np.clip(48 + 16 * x, 4, 91))
        frame[42:48, cx - 4:cx + 5] = (40, 40, 200)  # the cart
        for r in np.linspace(0.0, 30.0, 31):  # the pole
            py, px = int(44 - r * np.cos(theta)), int(cx + r * np.sin(theta))
            if 0 <= py < 64 and 0 <= px < 96:
                frame[py, px] = (200, 120, 40)
        return frame


def dg_config_e(e_dir, wrapper_e, state_e, timer, device: str = "cuda"):
    """Config E's run directory reloaded: ``load_experiment`` and ``load_agent``
    against the run's own model and a hand-built agent (to 0.0), a warm
    ``act`` timed and traced, ``DatasetEvaluator``'s prediction pass card
    against CPU, ``Visualizer`` with the planner and ``FineTuner`` with the
    planner. ``state_e`` is the state the run saved last, as it was in memory."""
    from mbrl_tpu_torch.config import Config, complete_agent_cfg, instantiate
    from mbrl_tpu_torch.diagnostics import DatasetEvaluator, FineTuner, Visualizer
    from mbrl_tpu_torch.diagnostics.common import load_experiment
    from mbrl_tpu_torch.envs import reward_fns, termination_fns
    from mbrl_tpu_torch.models import ModelEnv
    from mbrl_tpu_torch.planning import create_trajectory_optim_agent_for_model, load_agent
    from mbrl_tpu_torch.util import profiling

    def cfg_e():
        return Config(copy.deepcopy(CONFIG_E))

    e_dir = pathlib.Path(e_dir)
    out = {}
    with timer.phase("load_experiment"):
        _, env, wrapper, state, buffer, _, _ = load_experiment(e_dir, cfg=cfg_e(), device=device)
    rows = buffer.get_all()
    with torch.no_grad():
        got = wrapper.model.forward(state["params"], wrapper.process_batch(state, rows)[0])
        ref = wrapper_e.model.forward(state_e["params"], wrapper_e.process_batch(state_e, rows)[0])
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    check(err == 0.0, f"config DG: the reloaded model's forward differs from the run's by {err}")
    out["load_experiment"] = {"rows": buffer.num_stored, "forward_max_abs_err": err}

    # load_agent against an agent built by hand from the run's config and state
    with timer.phase("load_agent"):
        agent = load_agent(e_dir, env, cfg=cfg_e(), device=device)
    hand_cfg = cfg_e()
    hand = instantiate(complete_agent_cfg(env, hand_cfg.algorithm.agent, device=device), seed=1)
    hand = create_trajectory_optim_agent_for_model(
        ModelEnv(wrapper_e, termination_fns.cartpole, reward_fns.cartpole), hand,
        num_particles=hand_cfg.algorithm.num_particles)
    hand.set_eval_state(state_e)
    with timer.phase("act_first"):
        first = agent.act(DG_OBS)
    first_hand = hand.act(DG_OBS)
    err = float(np.abs(first - first_hand).max())
    check(err == 0.0 and bool(np.all(np.abs(first) <= 1.0)),
          f"config DG: load_agent's first action {first} is not the hand-built agent's {first_hand}")
    for _ in range(DG_WARM_ACTS):
        with timer.phase("act_warm"):
            agent.act(DG_OBS)
    # one warm act under the profiler: K2's symbol on the device, the
    # annotation on the host
    trace_dir = e_dir / "dg_trace"
    with profiling.trace(str(trace_dir)):
        with profiling.annotate("plan"):
            agent.act(DG_OBS)
    (trace_file,) = trace_dir.glob("trace_*.json")
    events = json.loads(trace_file.read_text())["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    k2_events = sum(1 for e in events if e.get("cat") == "kernel" and "gaussian_tc_kernel" in e["name"])
    annotated = [e.get("cat") for e in events if e.get("name") == "plan"]
    check(k2_events == 5 * 15 and annotated,
          f"config DG: the trace has {k2_events} K2 events and 'plan' in {annotated}")
    out["load_agent"] = {"first_action": first.tolist(), "vs_hand_built_max_abs_err": err,
                         "trace": {"file_mb": trace_file.stat().st_size / 2**20,
                                   "k2_events": k2_events, "plan_categories": sorted(set(annotated)),
                                   "device_kernels": kernels[:8]}}

    # DatasetEvaluator's prediction pass over the whole buffer, card against CPU
    preds = {}
    for dev in (device, "cpu"):
        ev = DatasetEvaluator(str(e_dir), str(e_dir), str(e_dir / "dg_eval"), cfg=cfg_e(), device=dev)
        ev.replay_buffer._rng = np.random.default_rng(SEED)  # the same shuffle on both
        with timer.phase(f"dataset_predict_{'card' if dev == device else 'cpu'}"):
            preds[dev] = ev.predict(ev.dataset())
    (means, targets), (means_cpu, targets_cpu) = preds[device], preds["cpu"]
    tol = TOL[("K3", "f32")]
    err, ok = max_err(torch.from_numpy(means), torch.from_numpy(means_cpu), tol)
    check(ok and np.array_equal(targets, targets_cpu) and means.shape == (ENSEMBLE, len(targets), OBS_E),
          f"config DG: DatasetEvaluator on the card vs the CPU: max abs err {err} (tol {tol})")
    out["dataset_evaluator"] = {"rows": len(targets), "card_vs_cpu_max_abs_err": err, "tol": tol}

    # Visualizer with the run's planner: one plan every lookahead steps
    with timer.phase("visualizer"):
        vis = Visualizer(DG_VIS["lookahead"], str(e_dir), agent_dir=str(e_dir),
                         num_steps=DG_VIS["num_steps"], num_model_samples=DG_VIS["num_model_samples"],
                         cfg=cfg_e(), device=device)
        rollouts = vis.compute()
    horizon = CONFIG_E["algorithm"]["agent"]["planning_horizon"]
    check(len(rollouts) == DG_VIS["num_steps"] // DG_VIS["lookahead"] and all(
        bool(np.isfinite(real).all()) and real.shape[1] == OBS_E and 2 <= len(real) <= horizon + 1
        and model.shape == (horizon + 1, DG_VIS["num_model_samples"], OBS_E)
        and bool(np.isfinite(model).all()) for _, real, model in rollouts),
        "config DG: Visualizer's rollouts " + str([(r.shape, m.shape) for _, r, m in rollouts]))
    out["visualizer"] = {"plans": len(rollouts), "real_steps": [len(r) - 1 for _, r, _ in rollouts],
                         "model_shape": list(rollouts[0][2].shape)}

    # FineTuner with the run's planner: collect, retrain, save
    with timer.phase("finetune"):
        ft = FineTuner(str(e_dir), str(e_dir), agent_type="planner", cfg=cfg_e(), device=device)
        ft.run(**DG_FT)
    written = sorted(p.name for p in ft.outdir.iterdir())
    losses = np.load(ft.outdir / "finetune_losses.npz")
    tuned = wrapper.load(wrapper.init(torch.Generator().manual_seed(0)), ft.outdir)
    with torch.no_grad():
        mean, _ = wrapper.model.forward(tuned["params"], wrapper.process_batch(tuned, rows)[0])
    check({"model.pkl", "replay_buffer.npz", "finetune_losses.npz"} <= set(written)
          and bool(np.isfinite(losses["train"]).all()) and bool(torch.isfinite(mean).all()),
          f"config DG: FineTuner wrote {written}, losses {losses['train']}")
    out["finetune"] = {"published": DG_FT_PUBLISHED, **{k: DG_FT[k] for k in ("num_epochs", "steps_to_collect")},
                       "written": written, "train_losses": losses["train"].tolist(),
                       "val_scores": losses["val"].tolist()}
    return out


def dg_config_m(m_dir, learner, timer, device: str = "cuda"):
    """Config M's run directory reloaded: ``load_agent``'s deterministic SAC
    actions against the learner's own policy as it was when it saved
    ``sac.pkl`` (to 0.0), and one evaluation episode recorded by a
    ``VideoRecorder``."""
    from mbrl_tpu_torch.algorithms import mbpo
    from mbrl_tpu_torch.config import Config
    from mbrl_tpu_torch.planning import load_agent
    from mbrl_tpu_torch.util.env import make_env
    from mbrl_tpu_torch.util.video import VideoRecorder

    cfg = Config(copy.deepcopy(CONFIG_M))
    env, _, _ = make_env(cfg)
    with timer.phase("load_agent_sac"):
        agent = load_agent(m_dir, env, cfg=cfg, device=device)
    sac, policy = learner
    obs = (0.1 * torch.randn((8, OBS_M), generator=torch.Generator().manual_seed(SEED + 50))).numpy()
    got = agent.act(obs, sample=False)
    ref = sac.act_tensor(policy, torch.as_tensor(obs, device=device),
                         torch.Generator(device=device).manual_seed(SEED), sample=False).cpu().numpy()
    err = float(np.abs(got - ref).max())
    check(got.shape == (8, ACT_M) and err == 0.0,
          f"config DG: load_agent's SAC actions differ from the learner's by {err}")
    test_env = RenderedCartpole(seeded_cartpole(make_env(cfg)[0]))
    recorder = VideoRecorder(pathlib.Path(m_dir) / "dg_video")
    with timer.phase("evaluate_with_video"):
        reward = mbpo.evaluate(test_env, agent, 1, video_recorder=recorder)
        recorder.save("0.mp4")
    written = sorted(p.name for p in recorder.save_dir.iterdir())
    check(len(written) == 1 and written[0].startswith("0.mp4") and len(recorder.frames) >= 1,
          f"config DG: the evaluation video wrote {written}")
    return {"sac_actions_vs_learner_max_abs_err": err, "eval_reward": float(reward),
            "video": {"files": written, "frames": len(recorder.frames),
                      "frame_shape": list(recorder.frames[0].shape)}}


def dg_config_pn(pn_dir, timer, device: str = "cuda"):
    """Config PN's run directory reloaded: ``PlanetVisualizer`` at
    ``planet.yaml``'s width (latent CEM 10 x 1,000 x 12, lookahead 50 from
    step 0) on ``PixelCheetah``; the prior replay's frames rendered on the card
    against a CPU model loaded from the same ``planet.pkl``; the artifact."""
    import contextlib
    import io

    from mbrl_tpu_torch.config import Config, instantiate
    from mbrl_tpu_torch.diagnostics import PlanetVisualizer

    kw = {k: v for k, v in DG_PV.items() if k not in ("start_step", "lookahead")}
    with timer.phase("planet_visualizer"), contextlib.redirect_stdout(io.StringIO()):
        vis = PlanetVisualizer(DG_PV["start_step"], DG_PV["lookahead"], str(pn_dir),
                               env=PixelCheetah(), cfg=Config(copy.deepcopy(CONFIG_PN)),
                               device=device, **kw)
        result = vis.compute()
    n = len(result["actions"])
    check(n == DG_PV["lookahead"] and result["pred_imgs"].shape == (n + 1, 64, 64, 3),
          f"config DG: PlanetVisualizer replayed {n} steps, frames {result['pred_imgs'].shape}")
    cfg_cpu = Config(copy.deepcopy(CONFIG_PN))
    cfg_cpu.dynamics_model["action_size"] = ACT_PN
    cpu = instantiate(cfg_cpu.dynamics_model, device="cpu")
    cpu_state = cpu.load(cpu.init(torch.Generator().manual_seed(0)), pn_dir)
    latents, beliefs = result["latents"].cpu(), result["beliefs"].cpu()
    frames_cpu = cpu.render(cpu_state, latents, beliefs)
    levels = np.abs(result["pred_imgs"].astype(int) - frames_cpu.astype(int))
    with torch.no_grad(), cpu.precision():
        dec_cpu = cpu._decode(cpu_state["params"], latents, beliefs)
    with torch.no_grad(), vis.planet.precision():
        dec = vis.planet._decode(vis.planet_state["params"], result["latents"],
                                 result["beliefs"]).cpu()
    rel = float((dec - dec_cpu).abs().max() / dec_cpu.abs().max())
    check(int(levels.max()) <= 1 and rel <= PN_TOL,
          f"config DG: PlanetVisualizer's frames card vs CPU: {int(levels.max())} levels, "
          f"decode rel err {rel}")
    with timer.phase("planet_visualizer_write"), contextlib.redirect_stdout(io.StringIO()):
        artifact = vis.write(result["true_obs"], result["pred_imgs"])
    check(artifact.exists(), f"config DG: {artifact} not written")
    return {"replayed_steps": n, "true_total_reward": result["true_total_reward"],
            "pred_total_reward": result["pred_total_reward"],
            "frames_card_vs_cpu": {"max_levels": int(levels.max()),
                                   "share_differing": float((levels > 0).mean()),
                                   "decode_rel_err": rel, "tol": PN_TOL},
            "artifact": artifact.name, "artifact_mb": artifact.stat().st_size / 2**20}


def dg_true_dynamics(timer, device: str = "cuda"):
    """``TrueDynamicsController`` on the numpy cartpole: one plan (CEM on the
    card, candidates scored by 4 worker processes on the real dynamics), in
    bounds, and its real return."""
    from mbrl_tpu_torch.diagnostics.control_env import TrueDynamicsController

    ctrl = TrueDynamicsController("cartpole_continuous", seed=SEED, device=device, **DG_TDC)
    try:
        state = ctrl.handler.get_current_state(ctrl.env)
        with timer.phase("true_dynamics_plan"):
            plan = ctrl.plan(state)
        obs = np.asarray(ctrl.env.state, np.float32)
        _, rewards, _ = ctrl.handler.rollout_env(ctrl.env, obs, len(plan), plan=plan)
    finally:
        ctrl.close()
    check(plan.shape == (DG_TDC["horizon"], ACT_E) and bool(np.all(np.abs(plan) <= 1.0)),
          f"config DG: TrueDynamicsController's plan {plan.shape} out of bounds")
    return {"plan_shape": list(plan.shape), "real_return": float(np.sum(rewards)),
            "max_return": DG_TDC["horizon"]}


def dg_tutorials(timer, device: str = "cuda"):
    """``tutorial_cem_rosenbrock`` at its defaults, card and CPU, and
    ``tutorial_fit_ensemble_1d`` at ``DG_FIT_EPOCHS``."""
    import contextlib
    import io

    from mbrl_tpu_torch.examples import tutorial_cem_rosenbrock, tutorial_fit_ensemble_1d

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        with timer.phase("tutorial_cem_rosenbrock"):
            best = tutorial_cem_rosenbrock.main(device=device)
        best_cpu = tutorial_cem_rosenbrock.main(device="cpu")
        with timer.phase("tutorial_fit_ensemble_1d"):
            rmse = tutorial_fit_ensemble_1d.main(num_epochs=DG_FIT_EPOCHS, device=device)
    # the mean aleatoric variances left and right of 0, as the tutorial prints them
    left, right = buf.getvalue().split("aleatoric var left ")[-1].split(" (")[0].split(" vs right ")
    stats = {"rmse": rmse, "aleatoric_left": float(left), "aleatoric_right": float(right)}
    check(best > ROSENBROCK_THRESHOLD and best_cpu > ROSENBROCK_THRESHOLD,
          f"config DG: Rosenbrock best {best} (card), {best_cpu} (CPU)")
    check(rmse < FIT_RMSE and stats["aleatoric_left"] < stats["aleatoric_right"],
          f"config DG: the 1-D fit {stats}")
    return {"rosenbrock_best": {"card": best, "cpu": best_cpu},
            "fit_ensemble_1d": {"epochs": DG_FIT_EPOCHS, "published_epochs": DG_FIT_PUBLISHED,
                                **stats}}


def dg_tutorial_pets(timer, device: str = "cuda"):
    """``tutorial_pets.main(num_steps=DG_TUT_STEPS)``: its episodes, read
    from what it prints."""
    import contextlib
    import io

    from mbrl_tpu_torch.examples import tutorial_pets

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), timer.phase("tutorial_pets"):
        best = tutorial_pets.main(num_steps=DG_TUT_STEPS, device=device)
    lines = [line.split("|") for line in buf.getvalue().splitlines() if line.startswith("steps")]
    env_steps = int(lines[-1][0].split()[1])
    rewards = [float(line[1].split()[-1]) for line in lines]
    check(env_steps >= DG_TUT_STEPS and bool(np.isfinite(best)),
          f"config DG: tutorial_pets ran {env_steps} steps, best {best}")
    return {"num_steps": DG_TUT_STEPS, "published_num_steps": DG_TUT_PUBLISHED,
            "env_steps": env_steps, "episode_rewards": rewards, "best_episode_reward": float(best)}


# --------------------------------------------------------------------------- #
# POOL-E and POOL-M: the batched loops over a pool of worker processes
# --------------------------------------------------------------------------- #
POOL_WORKERS = 4
# POOL-E: E's run over the pool; 100 batched steps after the exploration, and
# trial_length cut from 200 to 100 so that every worker ends an episode
POOL_E_STEPS, POOL_E_TRIAL = 400, 100
# POOL-M: M's run over the pool, two epochs of 200 environment steps (two
# retrainings; SAC updates from the first one on)
POOL_M_STEPS = 400


class PoolRecorder:
    """Stands in for ``distributed_collect.maybe_make_collector``: keeps the
    collector it makes, the host time at which each batched step returned and,
    as the pool closes, the workers' own report."""

    def __init__(self, module):
        self.orig = module.maybe_make_collector
        self.step_times, self.info, self.collector = [], None, None

    def __call__(self, cfg, seed=0):
        col = self.orig(cfg, seed=seed)
        if col is None:
            return None
        self.collector = col
        step, close = col.step, col.close

        def timed_step(actions):
            out = step(actions)
            self.step_times.append(time.perf_counter())
            return out

        def closing():
            self.info = col.pool.worker_info()
            close()

        col.step, col.close = timed_step, closing
        return col

    def workers(self) -> dict:
        check(self.info is not None and len(self.info) == POOL_WORKERS,
              f"the pool reported {self.info}")
        check(not any(i["cuda_initialized"] for i in self.info),
              f"a pool worker initialised CUDA: {self.info}")
        return {"workers": len(self.info), "pids": [i["pid"] for i in self.info],
                "cuda_initialized": [i["cuda_initialized"] for i in self.info],
                "torch_imported": ["torch" in i["packages"] for i in self.info]}


def pool_config_e(device: str = "cuda", config=None):
    """``pets.train`` with ``CONFIG_E`` (or ``config``) over a pool of
    ``POOL_WORKERS`` forkserver workers of the port's cartpole
    (``overrides.num_env_workers``): every batched step plans for each worker
    through ``act(batched=True)``. Returns the run's numbers."""
    import contextlib
    import io
    from unittest import mock

    from mbrl_tpu_torch.algorithms import pets
    from mbrl_tpu_torch.config import Config
    from mbrl_tpu_torch.envs import reward_fns, termination_fns
    from mbrl_tpu_torch.parallel import distributed_collect

    cfg = Config(copy.deepcopy(CONFIG_E if config is None else config))
    cfg.overrides["num_steps"] = POOL_E_STEPS
    cfg.overrides["trial_length"] = POOL_E_TRIAL
    cfg.overrides["num_env_workers"] = POOL_WORKERS
    freq = cfg.algorithm.freq_train_model
    rec = PoolRecorder(distributed_collect)
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_pool_e_")
    try:
        with mock.patch.object(distributed_collect, "maybe_make_collector", rec), \
                contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            best = pets.train(seeded_cartpole(), termination_fns.cartpole, reward_fns.cartpole,
                              cfg, silent=False, work_dir=work_dir, device=device)
            total_s = time.perf_counter() - t0
        log = read_csv(pathlib.Path(work_dir) / "results.csv")
        train_log = read_csv(pathlib.Path(work_dir) / "model_train.csv")
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    steps = len(rec.step_times)
    check(steps == POOL_E_STEPS // POOL_WORKERS, f"POOL-E: {steps} batched steps")
    # a retraining runs before the step at which env_steps crosses the cadence
    env_steps = np.arange(steps) * POOL_WORKERS
    retrains = (env_steps == 0) | (env_steps // freq != (env_steps + POOL_WORKERS) // freq)
    gaps = np.diff(np.asarray(rec.step_times)) * 1e3  # gap k: before step k + 1
    plain = gaps[~retrains[1:]]
    check(len(set(np.asarray(train_log["train_iteration"], int))) == int(retrains.sum()),
          f"POOL-E: {len(set(train_log['train_iteration']))} retrainings logged, "
          f"{int(retrains.sum())} cadence crossings")
    episodes = log["episode_reward"] if log else []
    check(len(episodes) >= POOL_WORKERS and bool(np.isfinite(episodes).all()),
          f"POOL-E: {len(episodes)} episodes logged")
    return {
        "workers": POOL_WORKERS, "num_steps": POOL_E_STEPS, "trial_length": POOL_E_TRIAL,
        "batched_steps": steps, "retrainings": int(retrains.sum()),
        "episodes": len(episodes), "episode_rewards": [float(r) for r in episodes],
        "episode_env_steps": [int(s) for s in log["env_step"]] if log else [],
        "best_episode_reward": float(best), "total_s": total_s,
        "batched_step_ms_median": float(np.median(plain)),
        "batched_step_ms_p90": float(np.percentile(plain, 90)),
        "env_step_ms_median": float(np.median(plain)) / POOL_WORKERS,
        "retrain_step_ms_median": float(np.median(gaps[retrains[1:]])),
        **rec.workers(),
    }


def pool_config_m(device: str = "cuda", config=None):
    """``mbpo.train`` with ``CONFIG_M`` (or ``config``) over a pool of
    ``POOL_WORKERS`` workers of the port's capped cartpole: one
    ``SACAgent.act(batched=True)`` per batched step, ``env_steps`` advancing by
    the pool's width, ``POOL_M_STEPS`` steps after M's exploration. Returns
    the run's numbers."""
    import contextlib
    import io
    from unittest import mock

    from mbrl_tpu_torch.algorithms import mbpo
    from mbrl_tpu_torch.config import Config
    from mbrl_tpu_torch.parallel import distributed_collect
    from mbrl_tpu_torch.planning.sac import SAC
    from mbrl_tpu_torch.util.env import make_env

    cfg = Config(copy.deepcopy(CONFIG_M if config is None else config))
    cfg.overrides["num_steps"] = POOL_M_STEPS
    cfg.overrides["num_env_workers"] = POOL_WORKERS
    env, term_fn, _ = make_env(cfg)
    test_env, _, _ = make_env(cfg)
    env, _ = seeded_cartpole(env), seeded_cartpole(test_env)
    freq = cfg.overrides.freq_train_model
    rec = PoolRecorder(distributed_collect)
    bundles = _Timed(SAC, "update_from_buffer", device)
    bundle = lambda self, *a, **kw: bundles(self, *a, **kw)  # noqa: E731
    rollouts = _Timed(mbpo, "imagined_rollout", device)
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_pool_m_")
    try:
        with mock.patch.object(distributed_collect, "maybe_make_collector", rec), \
                mock.patch.object(SAC, "update_from_buffer", bundle), \
                mock.patch.object(mbpo, "imagined_rollout", rollouts), \
                contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            best = mbpo.train(env, test_env, term_fn, cfg, silent=False, work_dir=work_dir,
                              device=device)
            total_s = time.perf_counter() - t0
        log = read_csv(pathlib.Path(work_dir) / "results.csv")
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    steps = len(rec.step_times)
    check(steps == POOL_M_STEPS // POOL_WORKERS, f"POOL-M: {steps} batched steps")
    retrainings = POOL_M_STEPS // freq
    check(len(rollouts.calls) == retrainings, f"POOL-M: {len(rollouts.calls)} imagined rollouts")
    check(len(log["episode_reward"]) == POOL_M_STEPS // cfg.overrides.epoch_length
          and bool(np.isfinite(log["episode_reward"]).all()), f"POOL-M: evaluations {log}")
    # the step after the first rollout on: a bundle of SAC updates each
    env_steps = np.arange(steps) * POOL_WORKERS
    crosses = lambda f: (env_steps + POOL_WORKERS) // f > env_steps // f  # noqa: E731
    first = int(np.flatnonzero(crosses(freq))[0])
    check(len(bundles.calls) == steps - first, f"POOL-M: {len(bundles.calls)} update bundles")
    gaps = np.diff(np.asarray(rec.step_times)) * 1e3  # gap k: after step k, before k + 1
    quiet = ~(crosses(freq) | crosses(cfg.overrides.epoch_length))[:-1]
    learning = quiet & (np.arange(steps - 1) >= first)
    bundle_ms = [c[0] for c in bundles.calls]
    n_updates = cfg.overrides.num_sac_updates_per_step
    return {
        "workers": POOL_WORKERS, "num_steps": POOL_M_STEPS, "batched_steps": steps,
        "retrainings": retrainings, "total_s": total_s, "best_eval_reward": float(best),
        "eval_rewards": log["episode_reward"],
        "rollout_ms": [c[0] for c in rollouts.calls],
        "batched_step_ms_median": float(np.median(gaps[learning])),
        "env_step_ms_median": float(np.median(gaps[learning])) / POOL_WORKERS,
        "batched_step_ms_before_learning": float(np.median(gaps[quiet & ~learning])),
        "sac_updates": len(bundle_ms) * n_updates,
        "sac_bundle_ms_median": float(np.median(bundle_ms)),
        "sac_updates_per_s": n_updates / (float(np.median(bundle_ms)) / 1e3),
        **rec.workers(),
    }


# --------------------------------------------------------------------------- #
# MESH-1 and MH: the mesh on the one card, and two processes on it
# --------------------------------------------------------------------------- #
MH_ROWS = 256  # E's model_batch_size: 128 rows a rank
MH_KEYS = 5  # evaluations of E's particles in MH: E's CEM iterations, 75 K2 launches a rank


def _trees_equal(a, b) -> bool:
    from mbrl_tpu_torch.ops.tree import tree_leaves_with_path

    la, lb = list(tree_leaves_with_path(a)), list(tree_leaves_with_path(b))
    return len(la) == len(lb) and all(
        pa == pb and (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
        for (pa, x), (pb, y) in zip(la, lb))


def mesh_one(device: str = "cuda", config_e=None, config_m=None, config_pn=None) -> dict:
    """``parallel=mesh`` on one process: E's first plan and a retraining, an
    imagined rollout at M's 80,000 rows and a training epoch at M's width,
    and one PlaNet update at PN's width (or at the sizes of the configs
    given), each with the one-process mesh's context and without: equal
    tensors (``torch.equal``) and equal launches."""
    import types

    from mbrl_tpu_torch.algorithms import mbpo
    from mbrl_tpu_torch.config import Config, complete_agent_cfg, create_one_dim_tr_model, instantiate
    from mbrl_tpu_torch.envs import reward_fns, termination_fns
    from mbrl_tpu_torch.models import ModelEnv, ModelTrainer, PlaNetModel
    from mbrl_tpu_torch.ops import kernels as K
    from mbrl_tpu_torch.parallel import make_parallel_context
    from mbrl_tpu_torch.planning import RandomAgent, create_trajectory_optim_agent_for_model
    from mbrl_tpu_torch.planning.sac import SAC
    from mbrl_tpu_torch.types import TransitionBatch
    from mbrl_tpu_torch.util import common as util_common
    from mbrl_tpu_torch.util.device_buffer import DeviceReplayBuffer, DeviceTransitionDataset
    from mbrl_tpu_torch.util.replay_buffer import ReplayBuffer

    pctx = make_parallel_context({"parallel": {"enable": True}})
    check(pctx.mesh.size == 1 and not torch.distributed.is_initialized(),
          f"MESH-1: the one-process mesh is {pctx.mesh}")
    out = {"mesh": dict(pctx.mesh.shape)}

    def both(run, what):
        """run(pctx or None) twice, counted; equal results and launches (the
        policy kernel's packs left out: the second run reuses the first's)."""
        got = []
        for ctx in (None, pctx):
            K.reset_launch_counts()
            result = run(ctx)
            got.append((result, {k: n for k, n in K.launch_counts().items()
                                 if k != "fused_policy_mlp.repacks"}))
        (a, ca), (b, cb) = got
        check(ca == cb, f"MESH-1 {what}: launches {ca} unsharded, {cb} on the mesh")
        check(_trees_equal(a, b), f"MESH-1 {what}: the mesh's result differs")
        out[what] = {"launches": ca}

    # E: a buffer of E's exploration, a retraining, then the first plan
    cfg = Config(copy.deepcopy(CONFIG_E if config_e is None else config_e))
    env = seeded_cartpole()
    buffer = ReplayBuffer(1000, (OBS_E,), (ACT_E,), obs_type=np.double, action_type=np.double,
                          reward_type=np.double, rng=np.random.default_rng(SEED))
    util_common.rollout_agent_trajectories(env, cfg.algorithm.initial_exploration_steps,
                                           RandomAgent(env), {}, replay_buffer=buffer)
    wrapper = create_one_dim_tr_model(cfg, (OBS_E,), (ACT_E,), device=device)
    state = wrapper.update_normalizer_host(wrapper.init(torch.Generator().manual_seed(SEED)),
                                           buffer.get_all())
    dataset = DeviceTransitionDataset(OBS_E, ACT_E, device=device)
    dataset.sync_from(buffer)
    ov = cfg.overrides

    def retrain_e(ctx):
        trainer = ModelTrainer(wrapper, optim_lr=ov.model_lr, weight_decay=ov.model_wd,
                               parallel_ctx=ctx)
        new, losses, vals = trainer.train_device(
            state, dataset, batch_size=ov.model_batch_size, val_ratio=ov.validation_ratio,
            num_epochs=ov.num_epochs_train_model, patience=ov.patience)
        return {"state": new, "losses": losses, "vals": vals}

    both(retrain_e, "E_retraining")
    trained = retrain_e(None)["state"]
    obs0 = env.reset(seed=SEED + 50)[0]

    def plan_e(ctx):
        model_env = ModelEnv(wrapper, termination_fns.cartpole, reward_fns.cartpole,
                             particle_sharding=ctx.particle_sharding() if ctx else None)
        agent = instantiate(complete_agent_cfg(env, cfg.algorithm.agent, device=device), seed=SEED + 1)
        agent = create_trajectory_optim_agent_for_model(model_env, agent,
                                                        num_particles=cfg.algorithm.num_particles)
        agent.set_eval_state(trained)
        return {"action": torch.as_tensor(agent.act(obs0))}

    both(plan_e, "E_first_plan")
    check(out["E_first_plan"]["launches"]["fused_ensemble_mlp_gaussian"] == 75 * (device == "cuda"),
          f"MESH-1: E's plan launched {out['E_first_plan']['launches']}")

    # M: one imagined rollout of 80,000 rows (K3) and one training epoch
    cfg_m = Config(copy.deepcopy(CONFIG_M if config_m is None else config_m))
    wrapper_m = create_one_dim_tr_model(cfg_m, (OBS_M,), (ACT_M,), device=device)
    # M's five elites, as its retrainings pick them: 80,000 rows shard over them (K3)
    state_m = wrapper_m.set_elite(wrapper_m.update_normalizer_host(
        wrapper_m.init(torch.Generator().manual_seed(SEED + 60)), buffer.get_all()),
        list(range(ELITES)))
    om = cfg_m.overrides
    sac = SAC(num_inputs=OBS_M, action_space=env.action_space, hidden_size=om.sac_hidden_size,
              device=device)
    sac_state = sac.init(torch.Generator().manual_seed(SEED + 61))
    rows = om.effective_model_rollouts_per_step * om.freq_train_model
    init_obs = torch.as_tensor(buffer.sample(rows).obs, dtype=torch.float32, device=device)

    def rollout_m(ctx):
        model_env = ModelEnv(wrapper_m, termination_fns.cartpole, None,
                             particle_sharding=ctx.particle_sharding() if ctx else None)
        sac_buffer = DeviceReplayBuffer(rows, OBS_M, ACT_M, device=device)
        buf = mbpo.imagined_rollout(model_env, state_m, sac, sac_state.policy, sac_buffer,
                                    sac_buffer.init(), init_obs,
                                    torch.Generator(device=device).manual_seed(SEED + 62), 1,
                                    cfg_m.algorithm.sac_samples_action)
        return {"rows": buf.arrays(), "stored": torch.as_tensor(int(buf.num_stored))}

    both(rollout_m, "M_rollout")
    check(out["M_rollout"]["launches"]["fused_ensemble_mlp"] == (device == "cuda"),
          f"MESH-1: M's rollout launched {out['M_rollout']['launches']}")

    def train_m(ctx):
        trainer = ModelTrainer(wrapper_m, optim_lr=om.model_lr, weight_decay=om.model_wd,
                               parallel_ctx=ctx)
        new, losses, vals = trainer.train_device(
            state_m, dataset, batch_size=om.model_batch_size, val_ratio=om.validation_ratio,
            num_epochs=1)
        return {"state": new, "losses": losses, "vals": vals}

    both(train_m, "M_training_epoch")

    # PN: one update of 50 windows of 50 steps at planet.yaml's width
    config_pn = CONFIG_PN if config_pn is None else config_pn
    kw = {k: v for k, v in config_pn["dynamics_model"].items() if k != "_target_"}
    kw["action_size"] = ACT_PN
    planet = PlaNetModel(**kw, device=device)
    pn_state = planet.init(torch.Generator().manual_seed(SEED + 70))
    rng = np.random.default_rng(SEED + 71)
    n = 200
    obs = torch.as_tensor(rng.integers(0, 256, (n, *kw["obs_shape"])).astype(np.uint8), device=device)
    act = torch.as_tensor(rng.uniform(-1, 1, (n, ACT_PN)).astype(np.float32), device=device)
    rew = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)
    flags = torch.zeros(n, dtype=torch.bool, device=device)
    pn_data = types.SimpleNamespace(data=TransitionBatch(obs, act, obs, rew, flags, flags),
                                    device=torch.device(device))
    pn = config_pn["overrides"]

    def update_pn(ctx):
        trainer = ModelTrainer(planet, optim_lr=1e-3, optim_eps=1e-4, parallel_ctx=ctx)
        new, losses = trainer.train_device_sequences(
            pn_state, pn_data, np.arange(n - pn["sequence_length"] + 1), num_updates=1,
            batch_size=pn["batch_size"], seq_len=pn["sequence_length"],
            generator=torch.Generator().manual_seed(SEED + 72))
        return {"params": new["params"], "losses": losses}

    # cuDNN's convolution backward may sum in another order from one call to
    # the next: the two updates are compared with its deterministic algorithms
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        both(update_pn, "PN_update")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    return out


def multihost_config_mh(device: str = "cuda") -> dict:
    """``run_multihost_dryrun(2)`` with both ranks on this card under gloo,
    ``model_axis_size=1`` (E's 7 members whole on each rank): ``psum=2``;
    one training step at E's width with the ``MH_ROWS`` rows of each member
    split over the two ranks, and one ``train_device`` epoch at E's batch
    size, each against the one-process call on the card in full float32;
    ``MH_KEYS`` evaluations of E's 350 x 20 particles on the fast path, each
    rank K2 on its block of 175 sequences (``MH_KEYS`` x 15 launches a rank),
    the two ranks' gathered returns equal and in statistical agreement with
    the one-process evaluations; one evaluation on the generic path (each
    rank K3 on its block of the elites, one launch a step), equal to the
    one-process one."""
    from mbrl_tpu_torch.device import full_float32
    from mbrl_tpu_torch.envs import reward_fns, termination_fns
    from mbrl_tpu_torch.models import ModelTrainer
    from mbrl_tpu_torch.ops.tree import tree_leaves_with_path
    from mbrl_tpu_torch.parallel import multihost
    from mbrl_tpu_torch.types import TransitionBatch

    e, ov = CONFIG_E["dynamics_model"], CONFIG_E["overrides"]
    rng = np.random.default_rng(SEED + 80)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    m, horizon = e["ensemble_size"], ov["planning_horizon"]
    plan = {"sequences": rng.uniform(-1, 1, (POP_E, horizon, ACT_E)).astype(np.float32),
            "initial_obs": (0.05 * f(OBS_E)), "num_particles": CONFIG_E["algorithm"]["num_particles"],
            "seed": SEED + 81, "fast_rollout": True, "keys": MH_KEYS,
            "reward_fn": reward_fns.cartpole, "termination_fn": termination_fns.cartpole}
    case = {
        "model": dict(in_size=OBS_E + ACT_E, out_size=OBS_E, num_layers=e["num_layers"],
                      ensemble_size=m, hid_size=e["hid_size"], activation=e["activation"],
                      propagation_method=e["propagation_method"]),
        "wrapper": dict(target_is_delta=True, normalize=True, learned_rewards=False),
        "state": None,
        "batch": (f(m, MH_ROWS, OBS_E), f(m, MH_ROWS, ACT_E), f(m, MH_ROWS, OBS_E),
                  f(m, MH_ROWS, 1), np.zeros((m, MH_ROWS, 1), bool), np.zeros((m, MH_ROWS, 1), bool)),
        "model_axis_size": 1,
        "train": {"batch_size": ov["model_batch_size"], "val_ratio": ov["validation_ratio"],
                  "epochs": 1, "seed": SEED + 82},
        "plan": plan,
        "plan_generic": {**plan, "fast_rollout": False, "keys": 1},
    }
    t0 = time.perf_counter()
    ranks = multihost.run_multihost_dryrun(2, device=device, case=case)  # checks psum=2
    dryrun_s = time.perf_counter() - t0
    dev = torch.device(device)
    wrapper, state = multihost._build(case, dev)
    trainer = ModelTrainer(wrapper)
    with full_float32():
        loss, grads = trainer.loss_and_grads(state, TransitionBatch(*case["batch"]))
    loss = float(loss)
    new, losses, vals = multihost.train_on_batch(trainer, state, case["batch"], case["train"], dev)
    params = {"/".join(map(str, k)): v.cpu().numpy() for k, v in tree_leaves_with_path(new["params"])}
    one = multihost.sharded_plan(wrapper, state, plan, None)
    one_generic = multihost.sharded_plan(wrapper, state, case["plan_generic"], None)
    err = {"loss": max(abs(r["loss"] - loss) / abs(loss) for r in ranks)}
    worst = {"grad": 0.0, "train_param": 0.0, "generic_value": 0.0}
    k2, k3 = "fused_ensemble_mlp_gaussian", "fused_ensemble_mlp"
    for r in ranks:
        check(r["mesh"] == {"model": 1, "data": 2}, f"MH: mesh {r['mesh']}")
        check(r["grads"].keys() == {"/".join(map(str, k)) for k in grads}, "MH: gradient leaves")
        for k, g in grads.items():
            got, ref = r["grads"]["/".join(map(str, k))], g.cpu().numpy()
            check(bool(np.allclose(got, ref, rtol=1e-5, atol=1e-6)),
                  f"MH: gradient {k} off by {float(np.abs(got - ref).max())}")
            worst["grad"] = max(worst["grad"], float(np.abs(got - ref).max()))
        check(bool(np.allclose(r["train_losses"], losses, rtol=1e-5)
                   and np.allclose(r["train_vals"], vals, rtol=1e-5)),
              f"MH: train_device losses {r['train_losses']} / {losses}, scores "
              f"{r['train_vals']} / {vals}")
        check(r["train_params"].keys() == params.keys(), "MH: train_device leaves")
        for k, v in params.items():
            check(bool(np.allclose(r["train_params"][k], v, rtol=1e-4, atol=1e-5)),
                  f"MH: train_device param {k} off by {float(np.abs(r['train_params'][k] - v).max())}")
            worst["train_param"] = max(worst["train_param"],
                                       float(np.abs(r["train_params"][k] - v).max()))
        if dev.type == "cuda":  # the plain versions on the CPU count no launch
            check(r["plan_launches"][k2] == MH_KEYS * horizon and r["plan_launches"][k3] == 0,
                  f"MH: a rank's fast-path launches {r['plan_launches']}, expected "
                  f"{MH_KEYS * horizon} K2")
            check(r["plan_generic_launches"][k3] == horizon
                  and r["plan_generic_launches"][k2] == 0,
                  f"MH: a rank's generic-path launches {r['plan_generic_launches']}, expected "
                  f"{horizon} K3")
        gen = float(np.abs(r["plan_generic_values"] - one_generic["values"]).max())
        check(bool(np.allclose(r["plan_generic_values"], one_generic["values"], rtol=1e-5,
                               atol=1e-6)), f"MH: generic-path values off by {gen}")
        worst["generic_value"] = max(worst["generic_value"], gen)
    check(err["loss"] <= 1e-5, f"MH: the two-rank loss is {err['loss']} off the one-process loss")
    check(dev.type != "cuda" or one["launches"][k2] == MH_KEYS * horizon,
          f"MH: one-process launches {one['launches']}")
    sharded, plain = ranks[0]["plan_values"], one["values"]
    check(bool(np.array_equal(sharded, ranks[1]["plan_values"])),
          "MH: the two ranks' gathered returns differ")
    check(bool(np.isfinite(sharded).all()) and sharded.shape == (MH_KEYS, POP_E),
          f"MH: sharded returns {sharded.shape}")
    # statistical agreement (tests/test_fast_rollout.py's method): every
    # (key, sequence) pair's difference has mean 0 within 5 standard errors,
    # and the spread over keys is not inflated
    diff = (sharded - plain).reshape(-1)
    z = float(diff.mean() / (diff.std() / np.sqrt(diff.size) + 1e-12))
    var_s, var_p = float(sharded.var(0, ddof=1).mean()), float(plain.var(0, ddof=1).mean())
    check(abs(z) < 5.0, f"MH: sharded returns' mean is off the one-process mean, z = {z}")
    check(var_s <= 1.5 * var_p + 1e-6, f"MH: sharded variance {var_s} > 1.5 x {var_p}")
    return {"processes": len(ranks), "dryrun_s": dryrun_s, "mesh": ranks[0]["mesh"], "rows": MH_ROWS,
            "loss_one_process": loss, "loss_ranks": [r["loss"] for r in ranks],
            "loss_rel_err": err["loss"], "grad_max_abs_err": worst["grad"], "tol": [1e-5, 1e-6],
            "train_device": {"losses": list(map(float, losses)),
                             "param_max_abs_err": worst["train_param"], "tol": [1e-4, 1e-5]},
            "plan": {"keys": MH_KEYS, "population": POP_E, "k2_launches_a_rank":
                     [r["plan_launches"][k2] for r in ranks], "z": z, "var_sharded": var_s,
                     "var_one_process": var_p, "mean_sharded": float(sharded.mean()),
                     "mean_one_process": float(plain.mean())},
            "plan_generic": {"k3_launches_a_rank": [r["plan_generic_launches"][k3] for r in ranks],
                             "max_abs_err": worst["generic_value"], "tol": [1e-5, 1e-6]}}


def published_config_e() -> int:
    """Config E alone at the published ``num_steps`` (5,000 planned steps,
    100 retrainings): its trial rewards, plan and retraining times, and the
    launches, all checked as in the default run."""
    from mbrl_tpu_torch.ops import kernels as K

    steps = 5000
    print(f"config E at its published num_steps {steps}", flush=True)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    numbers, _, _, work_dir = pets_config_e(planned_steps=steps)
    counts = wrapper_launches()
    shutil.rmtree(work_dir, ignore_errors=True)
    want = {"fused_rollout_returns": 0, "fused_ensemble_mlp_gaussian": numbers["planned_steps"] * 5 * 15,
            "fused_ensemble_mlp": 0}
    check(counts == want, f"config E: expected launches {want}, got {counts}")
    print("config E pets.train, published length: " + json.dumps(numbers) + f"  launches {counts}",
          flush=True)
    print(json.dumps({"E_published": {k: numbers[k] for k in (
        "planned_steps", "retrainings", "total_s", "best_episode_reward", "act_ms_median",
        "epoch_ms_mean", "gradient_steps_per_s")}, "total_s": time.perf_counter() - t0}), flush=True)
    return 0


def published_config_m() -> int:
    """Config M alone at the published ``num_steps`` (5,000 steps after the
    5,000 of exploration: 25 retrainings, 25 evaluations), everything else as
    ``CONFIG_M``; one progress line per epoch, then the run's numbers and
    launches, all checked as in the default run."""
    from mbrl_tpu_torch.ops import kernels as K

    config = copy.deepcopy(CONFIG_M)
    config["overrides"]["num_steps"] = M_PUBLISHED_STEPS
    print(f"config M at its published num_steps {M_PUBLISHED_STEPS}", flush=True)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    numbers, work_dir, _ = mbpo_config_m(config=config)
    counts = wrapper_launches()
    shutil.rmtree(work_dir, ignore_errors=True)
    want = {"fused_rollout_returns": 0, "fused_ensemble_mlp_gaussian": 0,
            "fused_ensemble_mlp": numbers["retrainings"]}  # rollout length 1
    check(counts == want, f"config M: expected launches {want}, got {counts}")
    print("config M mbpo.train, published length: " + json.dumps(numbers) + f"  launches {counts}",
          flush=True)
    print(json.dumps({"M_published": {k: numbers[k] for k in (
        "num_steps", "retrainings", "total_s", "best_eval_reward", "env_step_ms_median",
        "sac_updates_per_s")}, "total_s": time.perf_counter() - t0}), flush=True)
    return 0


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--published-e", action="store_true",
                        help="after the build, run config E alone at its published num_steps "
                             "(5,000) instead of the default phases")
    parser.add_argument("--published-m", action="store_true",
                        help="after the build, run config M alone at its published num_steps "
                             "(5,000) instead of the default phases")
    parser.add_argument("--policy", action="store_true",
                        help="after the build, check and time the SAC policy kernel alone")
    parser.add_argument("--k3-head", action="store_true",
                        help="after the build, check and time K3 with the Gaussian head alone")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA device",
              file=sys.stderr)
        return 2
    from mbrl_tpu_torch.ops import build

    print(card_line(), flush=True)
    t0 = time.perf_counter()
    cached = build.library_path().exists()
    build.build(verbose=True)
    build.load_library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s ({build.library_path().name}"
          f"{', already built' if cached else ''})", flush=True)
    if args.published_e or args.published_m or args.policy or args.k3_head:
        if args.published_e:
            published_config_e()
        elif args.published_m:
            published_config_m()
        elif args.policy:
            policy_kernel_checks()
        else:
            k3_head_checks()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    import contextlib

    with contextlib.ExitStack() as cleanup:
        return default_phases(t0, build_s, cleanup)


def default_phases(t0: float, build_s: float, cleanup) -> int:
    """Every phase after the build, in order. The run directories of configs
    E, M and PN stay until phase DG has reloaded them; ``cleanup`` (an
    ``ExitStack``) removes them, also when a check fails."""
    from mbrl_tpu_torch.ops import kernels as K

    results = kernel_checks()
    print("activations, ragged rows (max abs err): " + json.dumps(activation_sweep()), flush=True)
    print("width sweep: " + json.dumps(width_sweep()), flush=True)
    results.update(wide_kernel_checks())
    results.update(mbpo_kernel_checks())
    policy_kernel_checks()
    k3_head_checks()

    agree = {name: agreement(name, pop=40) for name in ("A", "B", "D")}
    print("agreement card vs cpu (identical members): " + json.dumps(agree), flush=True)

    # the main path, one config at a time: counts set to 0 just before each
    # config and read just after it
    def counted(run):
        K.reset_launch_counts()
        out = run()
        return out, wrapper_launches()

    times_a, counts_a = counted(lambda: plan_config("A"))
    times_b, counts_b = counted(lambda: plan_config("B"))
    times_c8, counts_c8 = counted(step_config_c)
    times_c100, counts_c100 = counted(rollout_config_c)
    times_d, counts_d = counted(lambda: plan_config("D"))
    counts_c = {k: counts_c8[k] + counts_c100[k] for k in counts_c8}
    print(f"config A act ms: {times_a}  launches {counts_a}", flush=True)
    print(f"config B act ms: {times_b}  launches {counts_b}", flush=True)
    print(f"config C step ms, {BATCH} rows: {times_c8}  launches {counts_c8}", flush=True)
    print(f"config C step ms, {MBPO_ROWS} rows (weights packed once): {times_c100}  "
          f"launches {counts_c100}", flush=True)
    print(f"config D act ms: {times_d}  launches {counts_d}", flush=True)
    expected = {
        "A": (counts_a, {"fused_rollout_returns": 15, "fused_ensemble_mlp_gaussian": 0,
                         "fused_ensemble_mlp": 0}),  # 5 K1 per plan, 3 plans
        "B": (counts_b, {"fused_rollout_returns": 0, "fused_ensemble_mlp_gaussian": 450,
                         "fused_ensemble_mlp": 0}),  # 5 x 30 K2 per plan, 3 plans
        "C": (counts_c, {"fused_rollout_returns": 0, "fused_ensemble_mlp_gaussian": 0,
                         "fused_ensemble_mlp": 5 + MBPO_STEPS}),  # one K3 per step
        "D": (counts_d, {"fused_rollout_returns": 0, "fused_ensemble_mlp_gaussian": 0,
                         "fused_ensemble_mlp": 450}),  # 5 x 30 K3 per plan, 3 plans
    }
    for name, (got, want) in expected.items():
        check(got == want, f"config {name}: expected launches {want}, got {got}")
    profiles = {name: device_busy(name) for name in ("A", "B", "D")}
    print("device profile: " + json.dumps(profiles), flush=True)

    # config E: the PETS loop. K2 alone, 5 iterations x 15 steps per planned step
    k2 = "fused_ensemble_mlp_gaussian"
    only_k2 = lambda n: {"fused_rollout_returns": 0, k2: n, "fused_ensemble_mlp": 0}
    print(f"config E: num_steps cut from 5000 to {E_PLANNED_STEPS} planned steps after "
          f"{CONFIG_E['algorithm']['initial_exploration_steps']} of random exploration (the run "
          "ends at the first episode boundary after that)", flush=True)
    (pets_numbers, wrapper_e, state_e, e_dir), counts_e = counted(pets_config_e)
    cleanup.callback(shutil.rmtree, e_dir, ignore_errors=True)
    print("config E pets.train: " + json.dumps(pets_numbers) + f"  launches {counts_e}", flush=True)
    want_e = only_k2(pets_numbers["planned_steps"] * 5 * 15)
    check(counts_e == want_e, f"config E: expected launches {want_e}, got {counts_e}")
    train_t = train_config_t()
    print("config T training: " + json.dumps(train_t), flush=True)
    times_mppi, counts_mppi = counted(plan_mppi)
    print(f"MPPI act ms: {times_mppi}  launches {counts_mppi}", flush=True)
    check(counts_mppi == only_k2(3 * 5 * HORIZON),
          f"MPPI: expected launches {only_k2(3 * 5 * HORIZON)}, got {counts_mppi}")
    (times_icem, icem_sizes, icem_h), counts_icem = counted(lambda: plan_icem(wrapper_e, state_e))
    print(f"iCEM act ms: {times_icem}  populations {json.dumps(icem_sizes)}  "
          f"launches {counts_icem}", flush=True)
    check(counts_icem == only_k2(4 * 5 * icem_h),  # three acts and one plan
          f"iCEM: expected launches {only_k2(4 * 5 * icem_h)}, got {counts_icem}")
    times_batch, counts_batch = counted(act_batch_config_b)
    print(f"act_batch (4 environments, config B) ms: {times_batch}  launches {counts_batch}",
          flush=True)
    check(counts_batch == only_k2(3 * 4 * 5 * HORIZON),
          f"act_batch: expected launches {only_k2(3 * 4 * 5 * HORIZON)}, got {counts_batch}")

    # the wide route on the entry points: two acts of A (5 K1 each) and of B
    # (150 K2 each), three _forward_sharded (one K3 each: 8,000 and 100,000
    # rows at 512 wide, 8,000 at 1,024); then a warm act of B under the
    # profiler
    wide, counts_w = counted(wide_paths)
    print(f"{WIDE_HID}-wide model: " + json.dumps(wide) + f"  launches {counts_w}", flush=True)
    want_w = {"fused_rollout_returns": 2 * 5, k2: 2 * 5 * HORIZON, "fused_ensemble_mlp": 3}
    check(counts_w == want_w, f"{WIDE_HID}-wide model: expected launches {want_w}, got {counts_w}")
    print(f"device profile, config B at {WIDE_HID} wide: "
          + json.dumps(device_busy("B", acts=1, hid=WIDE_HID)), flush=True)

    # the propagation methods random_model leaves out: each case counted on
    # its own (K3 for fixed_model on a batch the elites shard, else none)
    props, _ = counted(propagation_paths)
    print("propagation methods, card vs CPU: " + json.dumps(props), flush=True)

    # config M: the MBPO loop. K3 alone, one launch per imagined step
    k3 = "fused_ensemble_mlp"
    only_k3 = lambda n: {"fused_rollout_returns": 0, k2: 0, k3: n}  # noqa: E731
    print(f"config M: num_steps cut from 5000 to {M_NUM_STEPS} (2 epochs) after "
          f"{CONFIG_M['algorithm']['initial_exploration_steps']} steps of exploration by the SAC agent; "
          f"dataset_size {CONFIG_M['algorithm']['dataset_size']}", flush=True)
    (mbpo_numbers, m_dir, m_learner), counts_m = counted(mbpo_config_m)
    cleanup.callback(shutil.rmtree, m_dir, ignore_errors=True)
    print("config M mbpo.train: " + json.dumps(mbpo_numbers) + f"  launches {counts_m}", flush=True)
    check(counts_m == only_k3(mbpo_numbers["retrainings"] * 1),  # rollout length 1
          f"config M: expected launches {only_k3(mbpo_numbers['retrainings'])}, got {counts_m}")
    mhc, counts_mhc = counted(mbpo_halfcheetah_shape)
    print("config M-HC: " + json.dumps(mhc) + f"  launches {counts_mhc}", flush=True)
    want_mhc = only_k3(sum(MHC_HORIZONS))
    check(counts_mhc == want_mhc, f"config M-HC: expected launches {want_mhc}, got {counts_mhc}")
    # every rollout step's policy call on the policy kernel, one pack
    policy_mhc = (K.fused_policy_mlp.launches, K.fused_policy_mlp.repacks)
    check(policy_mhc == (sum(MHC_HORIZONS), 1),
          f"config M-HC: policy kernel launches and packs {policy_mhc}")
    print("config M-HC SAC update, card vs CPU: " + json.dumps(sac_update_card_vs_cpu()), flush=True)

    # config PN: PlaNet's training, posterior updates and latent planning
    # launch none of K1-K3 (its convolutions and narrow products are cuDNN's
    # and cuBLAS's in full float32); then card against CPU on a fixed batch
    print(f"config PN: num_episodes cut from {PN_PUBLISHED['num_episodes']} to {PN_EPISODES}, "
          f"dataset_size from {PN_PUBLISHED['dataset_size']} to {PN_DATASET_SIZE}", flush=True)
    (planet_numbers, pn_dir), counts_pn = counted(planet_config_pn)
    cleanup.callback(shutil.rmtree, pn_dir, ignore_errors=True)
    print("config PN planet.train: " + json.dumps(planet_numbers) + f"  launches {counts_pn}",
          flush=True)
    check(counts_pn == only_k3(0), f"config PN: expected no kernel launch, got {counts_pn}")
    print("config PN card vs CPU: " + json.dumps(planet_card_vs_cpu()), flush=True)

    # config CL: the closed-loop driver at A's and B's full width, 20 MPC steps
    # each (counted), then its per-step times, profile, the hand-written loop
    # and the agent's act beside it (not counted); the toy integrator
    k1 = "fused_rollout_returns"
    cl, counts_cl = {}, {}
    for name in ("A", "B"):
        cl[name], counts_cl[name] = counted(lambda: closed_loop_config(name))
        cl[name].update(closed_loop_checks(name))
        print(f"config CL-{name} closed loop: " + json.dumps(cl[name]) + f"  launches {counts_cl[name]}",
              flush=True)
    # A: one K1 per CEM generation; B: one K2 per generation and horizon step;
    # both: one K3 per act-env step
    want_cl = {"A": {k1: CL_STEPS * 5, k2: 0, k3: CL_STEPS},
               "B": {k1: 0, k2: CL_STEPS * 5 * HORIZON, k3: CL_STEPS}}
    for name, want in want_cl.items():
        check(counts_cl[name] == want,
              f"config CL-{name}: expected launches {want}, got {counts_cl[name]}")
    print("closed loop, toy integrator on the card (final state, optimum 1): "
          + json.dumps(closed_loop_integrator()), flush=True)

    # config BE: pets.train with dynamics_model=basic_ensemble; no kernel
    # launch (its member forward is plain PyTorch under vmap, as the JAX
    # package's reaches no Pallas kernel); then card against CPU
    print(f"config BE: num_steps cut from 5000 to {BE_PLANNED_STEPS} planned steps", flush=True)
    (be_numbers, wrapper_be, state_be, be_dir), counts_be = counted(
        lambda: pets_config_e(planned_steps=BE_PLANNED_STEPS, config=CONFIG_BE, label="BE"))
    try:
        print("config BE pets.train: " + json.dumps(be_numbers) + f"  launches {counts_be}",
              flush=True)
        check(counts_be == only_k3(0), f"config BE: expected no kernel launch, got {counts_be}")
        from mbrl_tpu_torch.util.replay_buffer import ReplayBuffer

        buffer = ReplayBuffer(BE_PLANNED_STEPS, (OBS_E,), (ACT_E,), obs_type=np.double,
                              action_type=np.double, reward_type=np.double)
        buffer.load(be_dir)
        be_check = basic_ensemble_card_vs_cpu(wrapper_be, state_be, buffer.get_all())
        print("config BE card vs CPU: " + json.dumps(be_check), flush=True)
    finally:
        shutil.rmtree(be_dir, ignore_errors=True)

    # config DG: the run directories of E, M and PN reloaded through the
    # diagnostics, load_agent, video and profiling hooks, then the tutorials.
    # E's agents launch K2 at E's shape (75 a plan: two first acts, the warm
    # and the traced acts, Visualizer's 2 plans, FineTuner's 200) and
    # Visualizer's model rollouts K3 (one a step of its 15-step plans, at one
    # row per elite); M, PN, the true-dynamics controller and two tutorials
    # none; tutorial_pets K2 at its own shape, 75 a step
    from mbrl_tpu_torch.util.profiling import StepTimer

    print(f"config DG: FineTuner's steps_to_collect cut from {DG_FT_PUBLISHED['steps_to_collect']} "
          f"to {DG_FT['steps_to_collect']} and num_epochs from {DG_FT_PUBLISHED['num_epochs']} to "
          f"{DG_FT['num_epochs']}; tutorial_pets' num_steps from {DG_TUT_PUBLISHED} to "
          f"{DG_TUT_STEPS}; the 1-D fit's epochs from {DG_FIT_PUBLISHED} to {DG_FIT_EPOCHS}",
          flush=True)
    timer = StepTimer()
    t_dg = time.perf_counter()
    dg = {}
    dg["E"], counts_dg = counted(lambda: dg_config_e(e_dir, wrapper_e, state_e, timer))
    print("config DG on E's run: " + json.dumps(dg["E"]) + f"  launches {counts_dg}", flush=True)
    vis_plans = DG_VIS["num_steps"] // DG_VIS["lookahead"]
    plans = 2 + DG_WARM_ACTS + 1 + vis_plans + DG_FT["steps_to_collect"]
    want_dg = {"fused_rollout_returns": 0, k2: plans * 5 * 15,
               k3: vis_plans * CONFIG_E["algorithm"]["agent"]["planning_horizon"]}
    check(counts_dg == want_dg, f"config DG on E's run: expected launches {want_dg}, got {counts_dg}")
    dg["M"], counts = counted(lambda: dg_config_m(m_dir, m_learner, timer))
    print("config DG on M's run: " + json.dumps(dg["M"]) + f"  launches {counts}", flush=True)
    check(counts == only_k3(0), f"config DG on M's run: expected no launch, got {counts}")
    dg["PN"], counts = counted(lambda: dg_config_pn(pn_dir, timer))
    print("config DG on PN's run: " + json.dumps(dg["PN"]) + f"  launches {counts}", flush=True)
    check(counts == only_k3(0), f"config DG on PN's run: expected no launch, got {counts}")
    dg["true_dynamics"], counts = counted(lambda: dg_true_dynamics(timer))
    dg["tutorials"], counts_t = counted(lambda: dg_tutorials(timer))
    print("config DG true dynamics and tutorials: " + json.dumps(
        {k: dg[k] for k in ("true_dynamics", "tutorials")}) + f"  launches {counts}, {counts_t}",
        flush=True)
    check(counts == counts_t == only_k3(0), f"config DG: expected no launch, got {counts}, {counts_t}")
    dg["tutorial_pets"], counts_tut = counted(lambda: dg_tutorial_pets(timer))
    print("config DG tutorial_pets: " + json.dumps(dg["tutorial_pets"]) + f"  launches {counts_tut}",
          flush=True)
    want_tut = only_k2(dg["tutorial_pets"]["env_steps"] * 5 * 15)
    check(counts_tut == want_tut, f"tutorial_pets: expected launches {want_tut}, got {counts_tut}")
    dg_s = time.perf_counter() - t_dg
    print(f"config DG phases ({dg_s:.1f} s):\n" + timer.report(), flush=True)
    dg_summary = timer.summary()

    # configs POOL-E and POOL-M: the batched loops over a pool of worker
    # processes. POOL-E plans for each worker at E's shape (75 K2 a plan);
    # POOL-M's imagined rollouts launch K3 at M's 80,000 rows, once a retraining
    print(f"config POOL-E: {POOL_WORKERS} workers, num_steps {POOL_E_STEPS} after "
          f"{CONFIG_E['algorithm']['initial_exploration_steps']} of exploration, trial_length "
          f"cut from {CONFIG_E['overrides']['trial_length']} to {POOL_E_TRIAL}", flush=True)
    pool_e, counts_pe = counted(pool_config_e)
    print("config POOL-E pets.train: " + json.dumps(pool_e) + f"  launches {counts_pe}", flush=True)
    want_pe = only_k2(pool_e["batched_steps"] * POOL_WORKERS * 5 * 15)
    check(counts_pe == want_pe, f"config POOL-E: expected launches {want_pe}, got {counts_pe}")
    print(f"config POOL-M: {POOL_WORKERS} workers, num_steps cut from {M_PUBLISHED_STEPS} to "
          f"{POOL_M_STEPS} after {CONFIG_M['algorithm']['initial_exploration_steps']} steps of "
          "exploration by the SAC agent", flush=True)
    pool_m, counts_pm = counted(pool_config_m)
    print("config POOL-M mbpo.train: " + json.dumps(pool_m) + f"  launches {counts_pm}", flush=True)
    want_pm = only_k3(pool_m["retrainings"] * 1)  # rollout length 1
    check(counts_pm == want_pm, f"config POOL-M: expected launches {want_pm}, got {counts_pm}")

    # config MESH-1: parallel=mesh on the one card equals the unsharded runs;
    # config MH: two processes on the card under gloo
    t_mesh = time.perf_counter()
    mesh1 = mesh_one()
    mesh1_s = time.perf_counter() - t_mesh
    print(f"config MESH-1, mesh against unsharded (torch.equal; {mesh1_s:.1f} s): "
          + json.dumps(mesh1), flush=True)
    mh = multihost_config_mh()
    print("config MH, two processes on the card: " + json.dumps(mh), flush=True)

    # K3 several times, each row checked and timed at the shape that its
    # launches had: C's 8,000-row steps, C's 100,000-row rollout, D's rollout
    # steps, M's imagined rollouts; the wide route's rows at 512 columns
    chain = {"K1": "mbrl_tpu_torch/csrc/tc_chain.cu", "K2": "mbrl_tpu_torch/csrc/tc_chain.cu",
             "K3": "mbrl_tpu_torch/csrc/ensemble_mlp.cu"}
    wide_src = {"K1": "mbrl_tpu_torch/csrc/wide_tc.cu", "K2": "mbrl_tpu_torch/csrc/wide_tc.cu",
                "K3": "mbrl_tpu_torch/csrc/ensemble_mlp_wide.cu"}
    wide_k3 = wide["forward_sharded_launches"]  # W's K3 launches, call by call
    rows = {  # row: (wrapper, the main path's dtype, its launches there, source)
        "K1": ("fused_rollout_returns", "bf16", counts_a["fused_rollout_returns"], chain["K1"]),
        "K2": (k2, "f32", counts_b[k2], chain["K2"]),
        "K2@E": (k2, "f32", counts_e[k2], chain["K2"]),
        "K2@MPPI": (k2, "f32", counts_mppi[k2], chain["K2"]),
        "K2@iCEM": (k2, "f32", counts_icem[k2], chain["K2"]),
        "K3": (k3, "f32", counts_c8[k3], chain["K3"]),
        "K3@C100k": (k3, "f32", counts_c100[k3], chain["K3"]),
        "K3@D": (k3, "f32", counts_d[k3], chain["K3"]),
        "K3@M": (k3, "f32", counts_m[k3], chain["K3"]),
        "K1@CL-A": ("fused_rollout_returns", "bf16", counts_cl["A"][k1], chain["K1"]),
        "K2@CL-B": (k2, "f32", counts_cl["B"][k2], chain["K2"]),
        "K3@CL-A": (k3, "bf16", counts_cl["A"][k3], chain["K3"]),
        "K3@CL-B": (k3, "f32", counts_cl["B"][k3], chain["K3"]),
        "K1@W512": ("fused_rollout_returns", "bf16", counts_w["fused_rollout_returns"], wide_src["K1"]),
        "K2@W512": (k2, "f32", counts_w[k2], wide_src["K2"]),
        "K3@W512": (k3, "f32", wide_k3[f"C8k@W{WIDE_HID}"], wide_src["K3"]),
        "K3@W512C100k": (k3, "f32", wide_k3[f"C100k@W{WIDE_HID}"], wide_src["K3"]),
        "K3@W1024": (k3, "f32", wide_k3[f"C8k@W{WIDEST_HID}"], wide_src["K3"]),
        "K2@DG": (k2, "f32", counts_dg[k2], chain["K2"]),
        "K3@DG": (k3, "f32", counts_dg[k3], chain["K3"]),
        "K2@TUT": (k2, "f32", counts_tut[k2], chain["K2"]),
        "K2@POOL-E": (k2, "f32", counts_pe[k2], chain["K2"]),
        "K3@POOL-M": (k3, "f32", counts_pm[k3], chain["K3"]),
    }
    for dt in ("f32", "bf16"):  # CL's K1 and K2 launch at A's and B's shapes, DG's K2 at E's,
        # POOL-E's K2 at E's and POOL-M's K3 at M's
        results[("K1@CL-A", dt)], results[("K2@CL-B", dt)] = results[("K1", dt)], results[("K2", dt)]
        results[("K2@DG", dt)] = results[("K2@E", dt)]
        results[("K2@POOL-E", dt)], results[("K3@POOL-M", dt)] = results[("K2@E", dt)], results[("K3@M", dt)]
    stated = ("tol", "rows", "route", "blocks", "rows_per_member")  # not measured: printed with the per-dtype rows above
    pr12 = {k: {dt: [results[(k, dt)]["ms"], PR12_MS[k][dt != rows[k][1]]] for dt in ("f32", "bf16")}
            for k in PR12_MS}
    print("chain rows, ms now and in PR 12: " + json.dumps(pr12), flush=True)
    line = []
    for k, (wrapper, dtype, launches, src) in rows.items():
        r = results[(k, dtype)]
        other = "f32" if dtype == "bf16" else "bf16"
        base = k.split("@")[0]
        route_kernels = PORT_KERNELS[3:6] if src in wide_src.values() else PORT_KERNELS[:3]
        if base == "K3":  # the source of the route it took
            src = K3_SOURCES[r["route"]]
        line.append({
            "name": f"{wrapper} ({k}, {dtype})",
            "kernel": (K3_KERNELS[r["route"]] if base == "K3"
                       else route_kernels[("K1", "K2").index(base)]),
            "route": "cuda",
            "source": src,
            "replaces": REPLACES[base],
            "tpu_kernel": REPLACES[base],
            "dtype": dtype,
            "launches": launches,
            "max_abs_err": r["max_abs_err"],
            "max_err": r["max_abs_err"],
            "ms": r["ms"],
            "kernel_ms": r["ms"],
            "eager_ms": r["eager_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
            "other_dtype": {"dtype": other, **{key: v for key, v in results[(k, other)].items()
                                               if key not in stated}},
        })
    print(json.dumps({"act_ms": {"A": times_a, "B": times_b, "D": times_d, "mppi": times_mppi,
                                 "icem": times_icem, "act_batch": times_batch,
                                 "E_median": pets_numbers["act_ms_median"],
                                 "W_A": wide["act_ms_A"], "W_B": wide["act_ms_B"]},
                      "propagation_max_abs_err": {k: v["max_abs_err"] for k, v in props.items()},
                      "step_ms": {"C8k": times_c8, "C100k": times_c100},
                      "mbpo_M": {k: mbpo_numbers[k] for k in (
                          "env_step_ms_median", "retrain_ms", "rollout_ms", "sac_updates_per_s",
                          "total_s")},
                      "mbpo_MHC": {k: mhc[k] for k in ("rollout_ms", "sac_updates_per_s")},
                      "closed_loop_CL": {name: {k: cl[name][k] for k in (
                          "step_ms_median", "step_ms_p90", "ms_per_step_mean",
                          "agent_act_ms_median", "driver_vs_hand_loop_max_abs_err")}
                          for name in cl},
                      "basic_ensemble_BE": {k: be_numbers[k] for k in (
                          "act_ms_median", "total_s", "best_episode_reward")},
                      "planet_PN": {k: planet_numbers[k] for k in (
                          "update_ms_median", "act_ms_median", "act_ms_p90",
                          "posterior_ms_median", "max_memory_allocated_gb", "total_s")},
                      "diagnostics_DG": {
                          "total_s": dg_s,
                          "phase_s": {k: v["total_s"] for k, v in dg_summary.items()},
                          "act_warm_ms_mean": dg_summary["act_warm"]["mean_ms"],
                          "planet_visualizer_ms_per_step": dg_summary["planet_visualizer"]["total_s"]
                          * 1e3 / DG_PV["lookahead"],
                          "finetune_collect_and_train_s": dg_summary["finetune"]["total_s"],
                          "tutorial_pets_ms_per_step": dg_summary["tutorial_pets"]["total_s"] * 1e3
                          / dg["tutorial_pets"]["env_steps"]},
                      "pool_POOL_E": {k: pool_e[k] for k in (
                          "batched_step_ms_median", "env_step_ms_median", "retrain_step_ms_median",
                          "episodes", "total_s")},
                      "pool_POOL_M": {k: pool_m[k] for k in (
                          "batched_step_ms_median", "env_step_ms_median", "sac_updates_per_s",
                          "total_s")},
                      "mesh_MESH_1": {"total_s": mesh1_s, **{k: v["launches"] for k, v in
                                                              mesh1.items() if k != "mesh"}},
                      "multihost_MH": {k: mh[k] for k in (
                          "loss_rel_err", "grad_max_abs_err", "dryrun_s")},
                      "build_s": build_s,
                      "total_s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
