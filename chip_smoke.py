#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``mbrl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the three CUDA kernels from ``mbrl_tpu_torch/csrc/`` (all on the tensor
cores: K1 and K2 in ``tc_chain.cu``, K3 in ``ensemble_mlp.cu``, one nvcc each),
holds each against its plain PyTorch version at the main path's shapes (f32 and
bf16; K3 at 8,000 rows with a Gaussian and with a deterministic head, and at
100,000 rows) and times both, then drives the port's
entry points at full width (7-member GaussianMLP ensemble, 5 elites, 4x200
silu; CEM pop 400 x 20 particles x horizon 30, 5 iterations) with random
weights from a seed:

  A  the bench shape (learned rewards, rotate, bf16): whole-horizon kernel K1
  B  the PETS-HalfCheetah config (preprocess, analytic reward, sort, f32): K2
  C  ModelEnv.step (TS1): 5 steps on 8,000 particles, and a 20-step rollout of
     100,000 rows, the batch of MBPO-HalfCheetah's imagined rollouts (uniform
     random actions stand in for the SAC policy, which is not ported): K3,
     with the weights packed once per rollout
  D  config B with a deterministic head: the per-step rollout on K3

and checks that each config's launches went through its kernel, that the
rollout on the card agrees with the plain CPU path on an identical-member
model. Prints the card, a JSON line of per-kernel numbers and, last,
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device, and on
any failed check. Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
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
                deterministic: bool = False):
    """A 5-elite packed stack from the port's own init, and the logvar bounds
    (None for a deterministic model)."""
    from mbrl_tpu_torch.models import GaussianMLP

    model = GaussianMLP(in_size, out_size, LAYERS, ENSEMBLE, HID, activation="silu",
                        deterministic=deterministic, compute_dtype=dtype, device="cuda")
    params = model.set_elite(model.init(g), list(range(ELITES)))
    p = model._elite_view(params)
    if deterministic:
        return model.pack(p), None, None
    return model.pack(p), p["max_logvar"].contiguous(), p["min_logvar"].contiguous()


def check_k3(K, x, stack, dt_name: str, what: str):
    """K3 against its plain version on ``x``; its times and bound."""
    tiles = K.pack_chain(stack)  # packed once, as a rollout does
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
        bf = dtype == torch.bfloat16
        # K3 / K2 at config B/C shapes: E=5, S=1600, in=24, out=18
        stack, max_lv, min_lv = elite_stack(OBS_B + ACT, OBS_B, dtype, g)
        x = torch.randn((ELITES, shard, OBS_B + ACT), generator=g).to(dev)
        flops = 2.0 * ELITES * shard * macs_per_row(stack.dims)

        results[("K3", dt_name)] = check_k3(K, x, stack, dt_name, "C8k")
        # K3 at config D's shape: the same rows into a deterministic head (18 columns)
        det, _, _ = elite_stack(OBS_B + ACT, OBS_B, dtype, g, deterministic=True)
        results[("K3@D", dt_name)] = check_k3(K, x, det, dt_name, "D")

        tiles = K.pack_chain(stack)  # the kernels' layout, packed once as the rollout does
        got = K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, OBS_B, sample=False,
                                            tiles=tiles)
        ref = K.fused_ensemble_mlp_gaussian_plain(g, x, stack, max_lv, min_lv, OBS_B, sample=False)
        err, ok = max_err(got, ref, TOL[("K2", dt_name)])
        check(ok, f"K2 {dt_name} (mean) disagrees with its plain version: max abs err {err}")
        # sampled path: z = (draw - mean) / sigma must be standard normal
        raw = K.fused_ensemble_mlp_plain(x, stack)
        sigma = torch.exp(0.5 * K.bound_logvar(raw[..., OBS_B:], max_lv, min_lv))
        draws = K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, OBS_B, sample=True,
                                              tiles=tiles)
        z = ((draws - ref) / sigma).double().flatten()
        n = z.numel()
        zm, zv = float(z.mean()), float(z.var())
        zk = float(((z - zm) ** 4).mean() / zv**2)
        check(abs(zm) < 5 / n**0.5 and abs(zv - 1) < 5 * (2 / n) ** 0.5 and abs(zk - 3) < 0.1,
              f"K2 {dt_name} samples are not N(0,1): mean {zm} var {zv} kurtosis {zk}")
        nbytes = stack_bytes(stack) + x.numel() * 4 + got.numel() * 4 + 2 * OBS_B * 4
        bms, bby = bound(flops, nbytes, bf)
        results[("K2", dt_name)] = {
            "max_abs_err": err, "tol": TOL[("K2", dt_name)], "z_mean": zm, "z_var": zv,
            "z_kurtosis": zk,
            "ms": time_graph_ms(
                lambda: K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, OBS_B, tiles=tiles), 20),
            "eager_ms": time_ms(
                lambda: K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, OBS_B, tiles=tiles), 20),
            "plain_ms": time_ms(
                lambda: K.fused_ensemble_mlp_gaussian_plain(g, x, stack, max_lv, min_lv, OBS_B), 10),
            "bound_ms": bms, "bound_by": bby,
        }

        # K1 at config A's shape: B=8000, H=30, obs 17, act 6, tile 64
        stack, max_lv, min_lv = elite_stack(OBS_A + ACT, OBS_A + 1, dtype, g)
        # K3 at the MBPO rollout's shape: E=5 x S=20,000, in 23, head 36 (many waves)
        x = torch.randn((ELITES, MBPO_ROWS // ELITES, OBS_A + ACT), generator=g).to(dev)
        results[("K3@C100k", dt_name)] = check_k3(K, x, stack, dt_name, "C100k")
        del x
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
        tiles = K.pack_chain(stack)
        got = K.fused_rollout_returns(g, *args, sample=False, tiles=tiles)
        ref = K.fused_rollout_returns_plain(g, *args, sample=False)
        err, ok = max_err(got, ref, TOL[("K1", dt_name)])
        check(ok, f"K1 {dt_name} (mean path) disagrees with its plain version: max abs err {err}")
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
              f"K1 {dt_name} sampled returns differ: max |dmean|/se {z_max}, var ratio {var_ratio}")
        flops = 2.0 * BATCH * HORIZON * macs_per_row(stack.dims)
        nbytes = stack_bytes(stack) + (obs0.numel() + acts.numel() + got.numel()) * 4
        bms, bby = bound(flops, nbytes, bf)
        results[("K1", dt_name)] = {
            "max_abs_err": err, "tol": TOL[("K1", dt_name)], "sampled_max_z": z_max,
            "sampled_var_ratio": var_ratio,
            "ms": time_graph_ms(lambda: K.fused_rollout_returns(g, *args, tiles=tiles), 5),
            "eager_ms": time_ms(lambda: K.fused_rollout_returns(g, *args, tiles=tiles), 5, warmup=1),
            "plain_ms": time_ms(lambda: K.fused_rollout_returns_plain(g, *args), 3, warmup=1),
            "bound_ms": bms, "bound_by": bby,
        }
        print(f"kernels {dt_name}: " + json.dumps(
            {k[0]: results[k] for k in results if k[1] == dt_name}), flush=True)
    return results


def activation_sweep():
    """K3 and K2 (mean path) for every activation, on a ragged row count
    (100 rows: one full 64-row tile and one partial), f32 and bf16; K3 also on
    a deterministic model's head (18 columns, not 36)."""
    from mbrl_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(SEED + 9)
    dev = torch.device("cuda")
    dims = (OBS_B + ACT, HID, HID, 2 * OBS_B)
    ws = [0.1 * torch.randn((ELITES, a, b), generator=g) for a, b in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn((ELITES, 1, b), generator=g) for b in dims[1:]]
    x = torch.randn((ELITES, 100, dims[0]), generator=g).to(dev)
    max_lv = torch.full((1, OBS_B), 0.5, device=dev)
    min_lv = torch.full((1, OBS_B), -10.0, device=dev)
    errs = {}
    for act in K.ACTIVATION_CODES:
        for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            stack = K.pack_mlp([w.to(dev) for w in ws[:-1]], [b.to(dev) for b in bs[:-1]],
                               ws[-1].to(dev), bs[-1].to(dev), act, dtype=dtype)
            tol = TOL[("K3", dt_name)]
            e3, ok3 = max_err(K.fused_ensemble_mlp(x, stack), K.fused_ensemble_mlp_plain(x, stack), tol)
            e2, ok2 = max_err(
                K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, OBS_B, sample=False),
                K.fused_ensemble_mlp_gaussian_plain(g, x, stack, max_lv, min_lv, OBS_B, sample=False),
                tol)
            det = K.pack_mlp([w.to(dev) for w in ws[:-1]], [b.to(dev) for b in bs[:-1]],
                             ws[-1][..., :OBS_B].contiguous().to(dev),
                             bs[-1][..., :OBS_B].contiguous().to(dev), act, dtype=dtype)
            ed, okd = max_err(K.fused_ensemble_mlp(x, det), K.fused_ensemble_mlp_plain(x, det), tol)
            check(ok3 and ok2 and okd, f"{act} {dt_name}: kernel vs plain max abs err K3 {e3}, "
                                       f"K2 {e2}, K3 deterministic head {ed}")
            errs[f"{act}/{dt_name}"] = max(e3, e2, ed)
    return errs


def widest_layer():
    """K3, K2 and K1 (mean paths) against their plain versions at the widest
    layer the kernels take (256 columns, 128 per warpgroup), f32 and bf16:
    K3 and K2 on ragged rows, K1 over 3 steps of 640 rows."""
    from mbrl_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(SEED + 10)
    dev = torch.device("cuda")
    wide = K.TC_MAX_WIDTH
    errs = {}
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for name, in_size, out in (("K3", OBS_B + ACT, OBS_B), ("K2", OBS_B + ACT, OBS_B),
                                   ("K1", OBS_A + ACT, OBS_A + 1)):
            dims = (in_size, wide, wide, 2 * out)
            ws = [(torch.randn((ELITES, a, b), generator=g) / a**0.5).to(dev)
                  for a, b in zip(dims[:-1], dims[1:])]
            bs = [(0.1 * torch.randn((ELITES, 1, b), generator=g)).to(dev) for b in dims[1:]]
            stack = K.pack_mlp(ws[:-1], bs[:-1], ws[-1], bs[-1], "silu", dtype=dtype)
            max_lv = torch.full((1, out), 0.5, device=dev)
            min_lv = torch.full((1, out), -10.0, device=dev)
            if name == "K1":
                batch, steps = ELITES * 2 * K.MAX_TILE, 3
                rot = torch.tensor([0, 3, 7], dtype=torch.int32, device=dev)
                obs0 = (0.1 * torch.randn((batch, OBS_A), generator=g)).to(dev)
                acts = (torch.rand((batch, steps, ACT), generator=g) * 2 - 1).to(dev)
                args = (rot, obs0, acts, torch.ones((1, OBS_A), device=dev), stack, max_lv, min_lv,
                        out, K.MAX_TILE)
                got = K.fused_rollout_returns(g, *args, sample=False)
                ref = K.fused_rollout_returns_plain(g, *args, sample=False)
            else:
                x = torch.randn((ELITES, 100, in_size), generator=g).to(dev)
                if name == "K2":
                    got = K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, out, sample=False)
                    ref = K.fused_ensemble_mlp_gaussian_plain(g, x, stack, max_lv, min_lv, out,
                                                              sample=False)
                else:
                    got = K.fused_ensemble_mlp(x, stack)
                    ref = K.fused_ensemble_mlp_plain(x, stack)
            err, ok = max_err(got, ref, TOL[(name, dt_name)])
            check(ok, f"{name} {dt_name} at width {wide} disagrees with its plain version: "
                      f"max abs err {err}")
            errs[f"{name}/{dt_name}"] = err
    return errs


# --------------------------------------------------------------------------- #
# Phases 3-5: the main path through the port's entry points
# --------------------------------------------------------------------------- #
def build_config(name: str, device: str, g: torch.Generator, identical: bool = False,
                 dtype: str = "bfloat16"):
    """Config A (with its model in ``dtype``), B or D: environment, state, obs width."""
    from mbrl_tpu_torch.envs import reward_fns, termination_fns
    from mbrl_tpu_torch.envs.pets_halfcheetah import HalfCheetahEnv
    from mbrl_tpu_torch.models import GaussianMLP, ModelEnv, TransitionRewardModel

    if name == "A":
        # bench.py:_build_env: learned rewards, rotate, bf16
        model = GaussianMLP(OBS_A + ACT, OBS_A + 1, LAYERS, ENSEMBLE, HID, activation="silu",
                            propagation_method="random_model", rollout_shuffle="rotate",
                            compute_dtype=dtype, device=device)
        wrapper = TransitionRewardModel(model, target_is_delta=True, normalize=True,
                                        learned_rewards=True)
        env_kw = {}
        obs_dim = OBS_A
    else:
        # B: overrides/pets_halfcheetah.yaml + gaussian_mlp_ensemble.yaml; D: the
        # same with that file's `deterministic` knob on
        model = GaussianMLP(OBS_B + ACT, OBS_B, LAYERS, ENSEMBLE, HID, activation="silu",
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


def make_agent(name: str, device: str = "cuda"):
    """The CEM MPC agent of config A, B or D: 5 iterations, elite ratio 0.16,
    alpha 0.12, mean of the elites, actions in [-1, 1]."""
    from mbrl_tpu_torch.planning import (
        CEMOptimizer, TrajectoryOptimizerAgent, create_trajectory_optim_agent_for_model,
    )

    g = torch.Generator().manual_seed(SEED + 1)
    env, state, obs_dim = build_config(name, device, g)
    lb, ub = -np.ones(ACT, np.float32), np.ones(ACT, np.float32)
    cem = CEMOptimizer(5, 0.16, POP, np.tile(lb, (HORIZON, 1)), np.tile(ub, (HORIZON, 1)),
                       alpha=0.12, return_mean_elites=True, device=device)
    agent = TrajectoryOptimizerAgent(cem, lb, ub, planning_horizon=HORIZON, replan_freq=1, seed=SEED)
    agent = create_trajectory_optim_agent_for_model(env, agent, num_particles=PARTICLES)
    agent.set_eval_state(state)
    return agent, obs_dim


def plan_config(name: str, device: str = "cuda"):
    agent, obs_dim = make_agent(name, device)
    lb, ub = -np.ones(ACT, np.float32), np.ones(ACT, np.float32)
    rng = np.random.default_rng(SEED)
    times = []
    for _ in range(3):
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


def device_busy(name: str, acts: int = 2):
    """Warm ``act``s of config A, B or D under ``torch.profiler``: the share of
    their wall time in which the card ran anything (union of device
    intervals), and the share in the port's own kernels. The profiler slows
    the host, so these wall times are not the ``act`` times above."""
    from torch.profiler import ProfilerActivity, profile

    agent, obs_dim = make_agent(name)
    rng = np.random.default_rng(SEED)
    agent.act((0.1 * rng.standard_normal(obs_dim)).astype(np.float32))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(acts):
            agent.act((0.1 * rng.standard_normal(obs_dim)).astype(np.float32))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    check(bool(spans), f"config {name}: the profiler saw no device activity")
    busy, end = 0.0, -float("inf")
    for s, e, _ in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    ours = sum(e - s for s, e, n in spans
               if n.split("<")[0].split()[-1] in ("rollout_returns_tc_kernel", "gaussian_tc_kernel",
                                                  "ensemble_mlp_tc_kernel"))
    by_name = {}
    for s, e, n in spans:
        by_name[n[:48]] = by_name.get(n[:48], 0.0) + (e - s) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"acts": acts, "wall_ms": wall_us / 1e3, "device_busy_share": busy / wall_us,
            "port_kernel_share": ours / wall_us, "device_ops": len(spans),
            "top_device_ms": dict(top)}


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


def main() -> int:
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

    results = kernel_checks()
    print("activations, ragged rows (max abs err): " + json.dumps(activation_sweep()), flush=True)
    print(f"widest layer, {K.TC_MAX_WIDTH} columns (max abs err): " + json.dumps(widest_layer()),
          flush=True)

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

    # K3 three times, each row checked and timed at the shape that its launches
    # had: C's 8,000-row steps, C's 100,000-row rollout, D's rollout steps
    k3 = "fused_ensemble_mlp"
    rows = {  # row: (wrapper, the main path's dtype, its launches there)
        "K1": ("fused_rollout_returns", "bf16", counts_a["fused_rollout_returns"]),
        "K2": ("fused_ensemble_mlp_gaussian", "f32", counts_b["fused_ensemble_mlp_gaussian"]),
        "K3": (k3, "f32", counts_c8[k3]),
        "K3@C100k": (k3, "f32", counts_c100[k3]),
        "K3@D": (k3, "f32", counts_d[k3]),
    }
    source = {"K1": "mbrl_tpu_torch/csrc/tc_chain.cu", "K2": "mbrl_tpu_torch/csrc/tc_chain.cu",
              "K3": "mbrl_tpu_torch/csrc/ensemble_mlp.cu"}
    stated = ("tol", "rows", "blocks")  # not measured: printed with the per-dtype rows above
    line = []
    for k, (wrapper, dtype, launches) in rows.items():
        r = results[(k, dtype)]
        other = "f32" if dtype == "bf16" else "bf16"
        line.append({
            "name": f"{wrapper} ({k}, {dtype})",
            "route": "cuda",
            "source": source[k.split("@")[0]],
            "replaces": REPLACES[k.split("@")[0]],
            "tpu_kernel": REPLACES[k.split("@")[0]],
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
    print(json.dumps({"act_ms": {"A": times_a, "B": times_b, "D": times_d},
                      "step_ms": {"C8k": times_c8, "C100k": times_c100}, "build_s": build_s,
                      "total_s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
