"""Shard-space fast path for ``ModelEnv.evaluate_action_sequences`` (counterpart
of ``mbrl_tpu/models/fast_rollout.py``).

The rollout runs in shard space: slot k of a packed (B, D+3) carry (obs,
accumulated reward, alive flag, sequence id) holds some particle; each step the
carry is re-shuffled by a fresh uniform permutation (``sort``), a random
whole-batch rotation (``rotate``), or not at all (``fixed_model``, TSinf), and
slot block m is served by elite member m. The input normalizer is folded into
the first layer, and per-sequence returns are read out with one segment sum.

Kernels. When the whole step fits K1's semantics (``rotate``, not fixed,
learned rewards, delta targets, no ``obs_process_fn``, no ``reward_fn``,
trivial termination, a stochastic head and a row tile that divides the member
shard), the whole horizon is one call of
:func:`~mbrl_tpu_torch.ops.kernels.fused_rollout_returns`. Otherwise every step's
member chain is one call of K2 (stochastic head) or K3 (deterministic head).
Each wrapper runs its plain PyTorch version on CPU tensors and launches its
CUDA kernel on CUDA tensors, at any width and depth: the tensor-core chain for
up to ``MAX_PRODUCTS`` products of at most 256 columns, else the wide route
(on the tensor cores too, with the wide route's tiles), as
:func:`~mbrl_tpu_torch.ops.kernels.takes_chain` picks. The tiles are the
model state's (``GaussianMLP.packed``). A wrapper raises only for weights of
another dtype than f32 or bf16, and for a stack or tiles that do not match
its dims.

Semantics match the generic path distribution-for-distribution; random
streams are consumed differently, so results agree statistically.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from mbrl_tpu_torch.device import randint, randperm
from mbrl_tpu_torch.envs import termination_fns
from mbrl_tpu_torch.ops import kernels


def _is_trivial_termination(termination_fn) -> bool:
    """True when the termination fn provably never ends an episode."""
    if termination_fn is None or getattr(termination_fn, "trivial", False):
        return True
    return termination_fn is termination_fns.no_termination


def supports_fast_rollout(wrapper, state: Dict[str, Any], batch: int) -> bool:
    """Static gate: the wrapper wraps a GaussianMLP-style ensemble whose
    equal-shard propagation applies to this batch size."""
    model = getattr(wrapper, "model", None)
    if model is None or not getattr(model, "supports_fast_rollout", False):
        return False
    if model.propagation_method not in ("random_model", "fixed_model"):
        return False
    params = state.get("params")
    if params is None or "elite" not in params:
        return False
    num_used = int(params["elite"].shape[0])
    return model.ensemble_size > 1 and batch % num_used == 0


def evaluate_action_sequences_sharded(
    wrapper,
    state: Dict[str, Any],
    action_sequences: torch.Tensor,  # (P, H, A)
    initial_obs: torch.Tensor,  # (D,)
    generator: torch.Generator,
    num_particles: int,
    reward_fn: Optional[Callable] = None,
    termination_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Expected return per candidate sequence, (P,). See module docstring."""
    model = wrapper.model
    dev = action_sequences.device
    # weight stack: normalizer folded into layer 0, cast once to compute_dtype,
    # with the kernels' own layout of it on the card; packed once per model state
    stats = state.get("normalizer") if wrapper.normalize else None
    cached = model.packed(state["params"], None if stats is None else (stats.mean, stats.std))
    p, stack, tiles = cached.view, cached.stack, cached.tiles
    num_used = p["head"]["w"].shape[0]
    population, horizon, act_dim = action_sequences.shape
    batch = population * num_particles
    shard = batch // num_used
    obs_dim = initial_obs.shape[-1]
    out_size = model.out_size
    stochastic = not model.deterministic
    fixed = model.propagation_method == "fixed_model"
    rotate = model.rollout_shuffle == "rotate"

    max_lv = p["max_logvar"].float().contiguous() if stochastic else None
    min_lv = p["min_logvar"].float().contiguous() if stochastic else None

    learned_rewards = wrapper.learned_rewards
    target_is_delta = wrapper.target_is_delta
    no_delta_list = wrapper.no_delta_list
    obs_process_fn = wrapper.obs_process_fn

    # K1: the whole horizon in one call when the step fits its semantics
    tile = kernels.pick_tile(shard) if stochastic else None
    if (
        tile is not None
        and rotate
        and not fixed
        and obs_process_fn is None
        and reward_fn is None
        and learned_rewards
        and target_is_delta
        and _is_trivial_termination(termination_fn)
    ):
        num_tiles = batch // tile
        rot = randint(generator, 0, num_tiles, (horizon,), "cpu")
        rot[0] = 0
        rot = (torch.cumsum(rot, 0) % num_tiles).to(device=dev, dtype=torch.int32)
        obs0_rows = initial_obs.float().expand(batch, obs_dim).contiguous()
        # strided particle layout: row r plans sequence (r % population), so a
        # sequence's particles spread over all row tiles, hence all members
        acts_rows = action_sequences.float().repeat(num_particles, 1, 1).contiguous()
        dmask = torch.ones((1, obs_dim), dtype=torch.float32, device=dev)
        for dim in no_delta_list:
            dmask[0, dim] = 0.0
        totals_rows = kernels.fused_rollout_returns(
            generator, rot, obs0_rows, acts_rows, dmask, stack, max_lv, min_lv,
            out_size, tile, tiles=tiles,
        )
        # particle p of sequence s is row p * population + s
        return totals_rows.reshape(num_particles, population).mean(dim=0)

    # per-step path: initial slot -> particle assignment; only sequence ids matter
    q0 = randperm(generator, batch, dev)
    seq0 = torch.div(q0, num_particles, rounding_mode="floor").float()
    if fixed:
        qs = None  # persistent assignment: the carry never re-shuffles
    elif rotate:
        qs = randint(generator, 0, batch, (horizon,), "cpu")
        qs[0] = 0
        qs = qs.tolist()
    else:
        qs = [None] + [randperm(generator, batch, dev) for _ in range(horizon - 1)]
    acts_by_time = action_sequences.float().transpose(0, 1)  # (H, P, A)

    obs0 = initial_obs.float().expand(batch, obs_dim)
    packed = torch.cat(
        [
            obs0,
            torch.zeros((batch, 1), device=dev),
            torch.ones((batch, 1), device=dev),
            seq0[:, None],
        ],
        dim=-1,
    )

    for t in range(horizon):
        q_t = None if qs is None else qs[t]
        if rotate and q_t:
            packed = torch.roll(packed, q_t, dims=0)  # re-shuffle = one roll
        elif q_t is not None and not rotate:
            packed = packed[q_t]  # re-shuffle = one gather
        obs = packed[:, :obs_dim]
        total = packed[:, obs_dim]
        alive = packed[:, obs_dim + 1]
        seq_ids = packed[:, obs_dim + 2].long()
        act_t = acts_by_time[t][seq_ids]

        x_obs = obs_process_fn(obs) if obs_process_fn is not None else obs
        x = torch.cat([x_obs, act_t], dim=-1).reshape(num_used, shard, -1).contiguous()
        if stochastic:
            pred = kernels.fused_ensemble_mlp_gaussian(
                generator, x, stack, max_lv, min_lv, out_size, tiles=tiles
            )
        else:
            pred = kernels.fused_ensemble_mlp(x, stack, tiles=tiles)
        pred = pred.reshape(batch, out_size)

        next_obs = pred[:, :-1] if learned_rewards else pred
        if target_is_delta:
            nxt = next_obs + obs
            for dim in no_delta_list:
                nxt[:, dim] = next_obs[:, dim]
            next_obs = nxt
        if reward_fn is None:
            rewards = pred[:, -1]
        else:
            rewards = reward_fn(act_t, next_obs).reshape(batch)
        terminated = termination_fn(act_t, next_obs).reshape(batch)

        total = total + alive * rewards
        alive = alive * (1.0 - terminated.float())
        packed = torch.cat(
            [next_obs, total[:, None], alive[:, None], packed[:, obs_dim + 2 :]], dim=-1
        )

    # per-sequence mean over particles: one segment-sum readout
    seq_ids = packed[:, obs_dim + 2].long()
    totals = torch.zeros((population,), dtype=torch.float32, device=dev)
    totals.index_add_(0, seq_ids, packed[:, obs_dim])
    return totals / num_particles
