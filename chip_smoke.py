#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``mbrl_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase below
    python3 chip_smoke.py --published-e   # config E alone at its published 5,000 steps
    python3 chip_smoke.py --published-m   # config M alone at its published 5,000 steps

Builds the CUDA kernels from ``mbrl_tpu_torch/csrc/`` (one nvcc per source, all
at once): K1, K2 and K3 on the tensor-core chain (``tc_chain.cu``,
``ensemble_mlp.cu``) and on the wide route, on the tensor cores too (K1 and K2
in ``wide_tc.cu``, K3's ``ensemble_mlp_wide_tc_kernel`` in
``ensemble_mlp_wide.cu``). Holds each against its
plain PyTorch version at the main paths' shapes (f32 and bf16; K3 at 8,000
rows with a Gaussian and with a deterministic head, at 100,000 rows and at
config M's 80,000; K2, mean path and samples, at the shapes of configs B and
E, of MPPI and of each of iCEM's populations; every activation at 200 and 300
columns; widths 256 to 1024 and a 12-product chain; the wide route timed at
512 columns, K3 there at 8,000 and 100,000 rows) and times both, then drives
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
     on the wide route; then a warm ``act`` of B under the profiler
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
     ``E_PLANNED_STEPS``: no K1-K3 launch; then the trained ensemble's forward,
     propagation, loss and gradient on the card against the CPU

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
OBS_E, ACT_E, POP_E = 4, 1, 350
MPPI_POP, ICEM_HORIZON = 350, 10
T_ROWS = 10_000
# the width sweep: two hidden layers of each width (256 is the chain's widest,
# the others take the wide route), then a chain of DEEP_PRODUCTS products;
# the wide route is timed at WIDE_HID columns
SWEEP_WIDTHS = (256, 264, 300, 512, 1024)
DEEP_PRODUCTS = 12
WIDE_HID = 512
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
                deterministic: bool = False, hid: int = HID):
    """A 5-elite packed stack from the port's own init, and the logvar bounds
    (None for a deterministic model)."""
    from mbrl_tpu_torch.models import GaussianMLP

    model = GaussianMLP(in_size, out_size, LAYERS, ENSEMBLE, hid, activation="silu",
                        deterministic=deterministic, compute_dtype=dtype, device="cuda")
    params = model.set_elite(model.init(g), list(range(ELITES)))
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
    return {
        "max_abs_err": err, "tol": tol, "rows": e * rows,
        "blocks": K.persistent_blocks(rows, e, K.sm_count(x.device)),
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


def check_k2(K, g, x, stack, max_lv, min_lv, dt_name: str, what: str):
    """K2 on ``x``: its mean path against its plain version, its samples
    against N(0,1), and its times and bound."""
    out = stack.dims[-1] // 2
    tol = TOL[("K2", dt_name)]
    # the layout of its route, packed once as the rollout does
    tiles = K.pack_tiles(stack)
    got = K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, out, sample=False, tiles=tiles)
    ref = K.fused_ensemble_mlp_gaussian_plain(g, x, stack, max_lv, min_lv, out, sample=False)
    err, ok = max_err(got, ref, tol)
    check(ok, f"K2 {dt_name} ({what}, mean) disagrees with its plain version: max abs err {err}")
    # sampled path: z = (draw - mean) / sigma must be standard normal
    raw = K.fused_ensemble_mlp_plain(x, stack)
    sigma = torch.exp(0.5 * K.bound_logvar(raw[..., out:], max_lv, min_lv))
    draws = K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, out, sample=True, tiles=tiles)
    zm, zv, zk = normal_moments((draws - ref) / sigma, f"K2 {dt_name} ({what})")
    e, rows, _ = x.shape
    flops = 2.0 * e * rows * macs_per_row(stack.dims)
    nbytes = stack_bytes(stack) + x.numel() * 4 + got.numel() * 4 + 2 * out * 4
    bms, bby = bound(flops, nbytes, stack.low_precision)

    def launch():
        return K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, out, tiles=tiles)

    return {
        "max_abs_err": err, "tol": tol, "rows": e * rows, "z_mean": zm, "z_var": zv,
        "z_kurtosis": zk, "ms": time_graph_ms(launch, 20), "eager_ms": time_ms(launch, 20),
        "plain_ms": time_ms(
            lambda: K.fused_ensemble_mlp_gaussian_plain(g, x, stack, max_lv, min_lv, out), 10),
        "bound_ms": bms, "bound_by": bby,
    }


def check_k1(K, g, stack, max_lv, min_lv, dt_name: str, what: str):
    """K1 at config A's shape (B=8000, H=30, obs 17, act 6, tile 64): its mean
    path against its plain version, its sampled returns against the plain
    version's within standard error, and its times and bound."""
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
    tiles = K.pack_tiles(stack, 4 * K.MAX_TILE * (OBS_A + 1))
    got = K.fused_rollout_returns(g, *args, sample=False, tiles=tiles)
    ref = K.fused_rollout_returns_plain(g, *args, sample=False)
    err, ok = max_err(got, ref, TOL[("K1", dt_name)])
    check(ok, f"K1 {dt_name} {what} (mean path) disagrees with its plain version: max abs err {err}")
    # sampled path: per-sequence mean returns agree within standard error
    n_seeds = 8

    def per_seq(fn):
        runs = torch.stack([fn(g, *args, sample=True).reshape(PARTICLES, POP) for _ in range(n_seeds)])
        runs = runs.reshape(-1, POP).double()
        return runs.mean(0), runs.var(0), runs.shape[0]

    mk, vk, nk = per_seq(functools.partial(K.fused_rollout_returns, tiles=tiles))
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
        "ms": time_graph_ms(lambda: K.fused_rollout_returns(g, *args, tiles=tiles), 5),
        "eager_ms": time_ms(lambda: K.fused_rollout_returns(g, *args, tiles=tiles), 5, warmup=1),
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
    member), K1 over 3 steps of 640 rows. Checks the route each took, and the
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
                carry = 4 * K.MAX_TILE * (OBS_A + 1) if name == "K1" else 0
                chain = K.takes_chain(dims, dtype == torch.bfloat16, carry)
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


def wide_kernel_checks():
    """K3, K2 and K1 on the wide route at ``WIDE_HID`` columns: the shapes of
    K3 ``C8k`` and ``C100k``, K2 ``B`` and K1 ``A`` with a 4 x ``WIDE_HID``
    model (the port's init, 5 elites), f32 and bf16, checked and timed as
    ``kernel_checks`` does."""
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
        stack, max_lv, min_lv = elite_stack(OBS_A + ACT, OBS_A + 1, dtype, g, hid=WIDE_HID)
        # K3 at the MBPO rollout's shape: E=5 x S=20,000, in 23, head 36
        x = torch.randn((ELITES, MBPO_ROWS // ELITES, OBS_A + ACT), generator=g).to(dev)
        results[("K3@W512C100k", dt_name)] = check_k3(K, x, stack, dt_name,
                                                      f"{WIDE_HID} wide, C100k")
        del x
        results[("K1@W512", dt_name)] = check_k1(K, g, stack, max_lv, min_lv, dt_name,
                                                 f"{WIDE_HID} wide")
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


# the CUDA kernels of K1, K2 and K3: on the chain, then on the wide route
PORT_KERNELS = ("rollout_returns_tc_kernel", "gaussian_tc_kernel", "ensemble_mlp_tc_kernel",
                "rollout_returns_wide_tc_kernel", "gaussian_wide_tc_kernel",
                "ensemble_mlp_wide_tc_kernel")


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
    wrappers = []

    def build_model(*a, **kw):
        wrappers.append(create(*a, **kw))
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
    launch, on the model's wide tiles) on the card against the same model on
    the CPU."""
    from mbrl_tpu_torch.models import GaussianMLP
    from mbrl_tpu_torch.ops import kernels as K

    out = {"act_ms_A": plan_config("A", device, hid=WIDE_HID, acts=2),
           "act_ms_B": plan_config("B", device, hid=WIDE_HID, acts=2)}
    vals = {}
    rows = BATCH
    x = torch.randn((rows, OBS_B + ACT), generator=torch.Generator().manual_seed(SEED + 12))
    perm = torch.randperm(rows, generator=torch.Generator().manual_seed(SEED + 13))
    for dev in (device, "cpu"):
        model = GaussianMLP(OBS_B + ACT, OBS_B, LAYERS, ENSEMBLE, WIDE_HID, activation="silu",
                            propagation_method="random_model", device=dev)
        params = model.set_elite(model.init(torch.Generator().manual_seed(SEED + 14)),
                                 list(range(ELITES)))
        packed = model.packed(params)
        check(not K.takes_chain(packed.stack.dims, False), "a 512-wide model took the chain")
        check(dev == "cpu" or isinstance(packed.tiles.layout, K.WideTileLayout),
              "a 512-wide model was not packed for the wide route")
        before = K.fused_ensemble_mlp.launches
        mean, logvar = model._forward_sharded(params, x.to(dev), perm.to(dev))
        want = 1 if dev == "cuda" else 0
        check(K.fused_ensemble_mlp.launches - before == want,
              f"_forward_sharded at {WIDE_HID} columns on {dev}: "
              f"{K.fused_ensemble_mlp.launches - before} K3 launches, not {want}")
        vals[dev] = (mean.float().cpu(), logvar.float().cpu())
    tol = TOL[("K3", "f32")]
    err = max(max_err(a, b, tol)[0] for a, b in zip(vals[device], vals["cpu"]))
    check(all(max_err(a, b, tol)[1] for a, b in zip(vals[device], vals["cpu"])),
          f"_forward_sharded at {WIDE_HID} columns: card vs CPU max abs err {err} (tol {tol})")
    out["forward_sharded_max_abs_err"] = err
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
                launches = K.launch_counts()
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
    evaluation. Returns the run's numbers and its work directory (the caller
    removes it)."""
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_mbpo_")
    try:
        return _mbpo_config_m(device, config, work_dir), work_dir
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
    }


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

    def timed_loss(self, work, batch, generator):
        starts.append(_stamp(device))
        out = loss(self, work, batch, generator)
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
    counts = K.launch_counts()
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
    numbers, work_dir = mbpo_config_m(config=config)
    counts = K.launch_counts()
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
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA device",
              file=sys.stderr)
        return 2
    from mbrl_tpu_torch.ops import build
    from mbrl_tpu_torch.ops import kernels as K

    print(card_line(), flush=True)
    t0 = time.perf_counter()
    cached = build.library_path().exists()
    build.build(verbose=True)
    build.load_library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s ({build.library_path().name}"
          f"{', already built' if cached else ''})", flush=True)
    if args.published_e or args.published_m:
        if args.published_e:
            published_config_e()
        else:
            published_config_m()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    results = kernel_checks()
    print("activations, ragged rows (max abs err): " + json.dumps(activation_sweep()), flush=True)
    print("width sweep: " + json.dumps(width_sweep()), flush=True)
    results.update(wide_kernel_checks())
    results.update(mbpo_kernel_checks())

    agree = {name: agreement(name, pop=40) for name in ("A", "B", "D")}
    print("agreement card vs cpu (identical members): " + json.dumps(agree), flush=True)

    # the main path, one config at a time: counts set to 0 just before each
    # config and read just after it
    def counted(run):
        K.reset_launch_counts()
        out = run()
        return out, K.launch_counts()

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
    (pets_numbers, wrapper_e, state_e, work_dir), counts_e = counted(pets_config_e)
    try:
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
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    # the wide route on the entry points: two acts of A (5 K1 each) and of B
    # (150 K2 each), one _forward_sharded (K3); then a warm act of B under the
    # profiler
    wide, counts_w = counted(wide_paths)
    print(f"{WIDE_HID}-wide model: " + json.dumps(wide) + f"  launches {counts_w}", flush=True)
    want_w = {"fused_rollout_returns": 2 * 5, k2: 2 * 5 * HORIZON, "fused_ensemble_mlp": 1}
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
    (mbpo_numbers, m_dir), counts_m = counted(mbpo_config_m)
    shutil.rmtree(m_dir, ignore_errors=True)
    print("config M mbpo.train: " + json.dumps(mbpo_numbers) + f"  launches {counts_m}", flush=True)
    check(counts_m == only_k3(mbpo_numbers["retrainings"] * 1),  # rollout length 1
          f"config M: expected launches {only_k3(mbpo_numbers['retrainings'])}, got {counts_m}")
    mhc, counts_mhc = counted(mbpo_halfcheetah_shape)
    print("config M-HC: " + json.dumps(mhc) + f"  launches {counts_mhc}", flush=True)
    want_mhc = only_k3(sum(MHC_HORIZONS))
    check(counts_mhc == want_mhc, f"config M-HC: expected launches {want_mhc}, got {counts_mhc}")
    print("config M-HC SAC update, card vs CPU: " + json.dumps(sac_update_card_vs_cpu()), flush=True)

    # config PN: PlaNet's training, posterior updates and latent planning
    # launch none of K1-K3 (its convolutions and narrow products are cuDNN's
    # and cuBLAS's in full float32); then card against CPU on a fixed batch
    print(f"config PN: num_episodes cut from {PN_PUBLISHED['num_episodes']} to {PN_EPISODES}, "
          f"dataset_size from {PN_PUBLISHED['dataset_size']} to {PN_DATASET_SIZE}", flush=True)
    (planet_numbers, pn_dir), counts_pn = counted(planet_config_pn)
    shutil.rmtree(pn_dir, ignore_errors=True)
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
    print(f"config BE: num_steps cut from 5000 to {E_PLANNED_STEPS} planned steps", flush=True)
    (be_numbers, wrapper_be, state_be, be_dir), counts_be = counted(
        lambda: pets_config_e(config=CONFIG_BE, label="BE"))
    try:
        print("config BE pets.train: " + json.dumps(be_numbers) + f"  launches {counts_be}",
              flush=True)
        check(counts_be == only_k3(0), f"config BE: expected no kernel launch, got {counts_be}")
        from mbrl_tpu_torch.util.replay_buffer import ReplayBuffer

        buffer = ReplayBuffer(E_PLANNED_STEPS, (OBS_E,), (ACT_E,), obs_type=np.double,
                              action_type=np.double, reward_type=np.double)
        buffer.load(be_dir)
        be_check = basic_ensemble_card_vs_cpu(wrapper_be, state_be, buffer.get_all())
        print("config BE card vs CPU: " + json.dumps(be_check), flush=True)
    finally:
        shutil.rmtree(be_dir, ignore_errors=True)

    # K3 several times, each row checked and timed at the shape that its
    # launches had: C's 8,000-row steps, C's 100,000-row rollout, D's rollout
    # steps, M's imagined rollouts; the wide route's rows at 512 columns
    chain = {"K1": "mbrl_tpu_torch/csrc/tc_chain.cu", "K2": "mbrl_tpu_torch/csrc/tc_chain.cu",
             "K3": "mbrl_tpu_torch/csrc/ensemble_mlp.cu"}
    wide_src = {"K1": "mbrl_tpu_torch/csrc/wide_tc.cu", "K2": "mbrl_tpu_torch/csrc/wide_tc.cu",
                "K3": "mbrl_tpu_torch/csrc/ensemble_mlp_wide.cu"}
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
        "K3@W512": (k3, "f32", counts_w[k3], wide_src["K3"]),
    }
    for dt in ("f32", "bf16"):  # CL's K1 and K2 launch at A's and B's shapes
        results[("K1@CL-A", dt)], results[("K2@CL-B", dt)] = results[("K1", dt)], results[("K2", dt)]
    stated = ("tol", "rows", "blocks", "rows_per_member")  # not measured: printed with the per-dtype rows above
    line = []
    for k, (wrapper, dtype, launches, src) in rows.items():
        r = results[(k, dtype)]
        other = "f32" if dtype == "bf16" else "bf16"
        base = k.split("@")[0]
        route_kernels = PORT_KERNELS[3:] if src in wide_src.values() else PORT_KERNELS[:3]
        line.append({
            "name": f"{wrapper} ({k}, {dtype})",
            "kernel": route_kernels[("K1", "K2", "K3").index(base)],
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
                      "build_s": build_s,
                      "total_s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
