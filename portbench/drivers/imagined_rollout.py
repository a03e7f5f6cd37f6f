"""The general generator of imagined-rollout traffic: rollouts back to back,
closed loop (the next one is issued when the last has been issued; nothing
waits for the card in between), each from ``start_states`` rows drawn on the
card, uniform with replacement, from the seeded real buffer, for ``horizon``
steps into the ring SAC buffer, as MBPO does after each retraining. The
traffic file gives ``start_states``, ``horizon`` and ``checked_rollouts``;
whether the policy samples its action is the configuration's
``sac_samples_action``.

The program's entry is ``mbrl_tpu_torch.algorithms.mbpo.imagined_rollout``.
With ``mode="control"`` the reference's own rollout (``reference.rollout``) in
TF32 products and a float32 normaliser takes its place.
"""
from __future__ import annotations

import types
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import inputs, reference

CONTROL_PRODUCTS = "tf32"


def _seed(seed: int, k: int) -> int:
    return (seed * 1_000_003 + k) % 2**63


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device, terminated,
                 scale: Optional[Dict] = None, mode: str = "program"):
        self.sz = sz = inputs.sizes(config, traffic, scale)
        if sz.start_states % sz.elites:
            raise ValueError(f"{sz.start_states} start states do not shard over {sz.elites} elites")
        self.seed, self.device, self.mode, self.terminated = seed, device, mode, terminated
        self.checked = traffic["checked_rollouts"]
        self.inp = inputs.make(config, sz, _seed(seed, 0), device)
        self.idx_gen = torch.Generator(device=device).manual_seed(_seed(seed, 1))
        self.gen = torch.Generator(device=device).manual_seed(_seed(seed, 2))
        self.records: List[tuple] = []
        if mode == "program":
            self._program(config, traffic)
        elif mode == "control":
            self.ring = reference.Ring.empty(sz.capacity, sz.obs, sz.act, device)
            self.control_norm = reference.fit_normalizer(self.inp.real_obs, self.inp.real_act,
                                                         dtype=torch.float32)
        else:
            raise ValueError(f"unknown mode {mode!r}")

    def _program(self, config: Dict, traffic: Dict) -> None:
        from mbrl_tpu_torch.algorithms import mbpo
        from mbrl_tpu_torch.envs import termination_fns
        from mbrl_tpu_torch.envs.spaces import Box
        from mbrl_tpu_torch.models import GaussianMLP, ModelEnv, TransitionRewardModel
        from mbrl_tpu_torch.ops import normalizer
        from mbrl_tpu_torch.planning.sac import SAC, GaussianPolicy
        from mbrl_tpu_torch.util.device_buffer import DeviceReplayBuffer

        sz, inp, dev = self.sz, self.inp, self.device
        dm, alg, ov = config["dynamics_model"], config["algorithm"], config["overrides"]
        if ov["sac_policy"] != "Gaussian":
            raise ValueError("this traffic drives the Gaussian SAC policy only")
        model = GaussianMLP(sz.model_in, sz.model_out, num_layers=dm["num_layers"],
                            ensemble_size=dm["ensemble_size"], hid_size=dm["hid_size"],
                            deterministic=dm["deterministic"],
                            propagation_method=dm["propagation_method"],
                            learn_logvar_bounds=dm["learn_logvar_bounds"],
                            activation=dm["activation"], device=dev)
        wrapper = TransitionRewardModel(
            model, target_is_delta=alg["target_is_delta"], normalize=alg["normalize"],
            normalize_double_precision=alg["normalize_double_precision"],
            learned_rewards=alg["learned_rewards"], num_elites=ov["num_elites"])
        # the program gets copies of the benchmark's weights, so that nothing it
        # does to them reaches the reference
        params = {
            "layers": [{"w": w.clone(), "b": b.clone()}
                       for w, b in zip(inp.layer_w[:-1], inp.layer_b[:-1])],
            "head": {"w": inp.layer_w[-1].clone(), "b": inp.layer_b[-1].clone()},
            "elite": inp.elite.clone(),
            "min_logvar": inp.min_logvar.clone(), "max_logvar": inp.max_logvar.clone(),
        }
        dtype = torch.float64 if alg["normalize_double_precision"] else torch.float32
        state = {"params": params,
                 "normalizer": normalizer.init_normalizer(sz.model_in, dev, dtype=dtype)}
        self.state = wrapper.update_normalizer(
            state, types.SimpleNamespace(obs=inp.real_obs, act=inp.real_act))
        self.model_env = ModelEnv(wrapper, getattr(termination_fns, ov["term_fn"]), None)
        space = Box(inp.action_low.cpu().numpy(), inp.action_high.cpu().numpy())
        self.sac = SAC(num_inputs=sz.obs, action_space=space, gamma=ov["sac_gamma"],
                       tau=ov["sac_tau"], alpha=ov["sac_alpha"], policy=ov["sac_policy"],
                       target_update_interval=ov["sac_target_update_interval"],
                       automatic_entropy_tuning=ov["sac_automatic_entropy_tuning"],
                       hidden_size=sz.policy_hidden, lr=ov["sac_lr"],
                       target_entropy=ov["sac_target_entropy"], device=dev)
        with torch.device(dev):
            self.policy = GaussianPolicy(sz.obs, sz.act, sz.policy_hidden)
        with torch.no_grad():
            for layer, w, b in zip((self.policy.linear1, self.policy.linear2,
                                    self.policy.mean_linear, self.policy.log_std_linear),
                                   inp.policy_w, inp.policy_b):
                layer.weight.copy_(w.t())
                layer.bias.copy_(b)
        self.buffer = DeviceReplayBuffer(sz.capacity, sz.obs, sz.act, device=dev)
        self.ring = self.buffer.init()
        self.sample_actions = alg["sac_samples_action"]
        self.mbpo = mbpo

    # ------------------------------------------------------------------ #
    @property
    def rows_per_rollout(self) -> int:
        return self.sz.start_states * self.sz.horizon

    def rollout(self) -> None:
        """One rollout, issued without waiting for the card."""
        self.records.append((self.gen.get_state(), self.idx_gen.get_state(),
                             self.ring.cur_idx.clone()))
        start = self.inp.real_obs[inputs.start_indices(self.idx_gen, self.sz)]
        if self.mode == "program":
            self.mbpo.imagined_rollout(self.model_env, self.state, self.sac, self.policy,
                                       self.buffer, self.ring, start, self.gen,
                                       self.sz.horizon, self.sample_actions)
        else:
            reference.rollout(self.inp, self.control_norm, start, self.gen, self.terminated,
                              self.ring, CONTROL_PRODUCTS)

    def free_program(self) -> None:
        """Drop what only the program holds (the ring stays: it is judged)."""
        for name in ("model_env", "state", "sac", "policy", "mbpo"):
            self.__dict__.pop(name, None)

    def judge(self) -> List[Dict[str, float]]:
        """The numbers compared, for ``checked_rollouts`` rollouts whose rows
        are still in the ring: the last one, and others drawn from the seed."""
        sz = self.sz
        cursors = [int(c) for c in torch.stack(
            [r[2] for r in self.records] + [self.ring.cur_idx]).tolist()]
        advance = [(b - a) % sz.capacity for a, b in zip(cursors[:-1], cursors[1:])]
        intact, written = [], 0
        for i in reversed(range(len(self.records))):
            written += advance[i]
            if written > sz.capacity:
                break
            intact.append(i)
        last, rest = intact[0], intact[1:]
        rng = np.random.default_rng(_seed(self.seed, 3))
        pick = rng.choice(len(rest), size=min(self.checked - 1, len(rest)), replace=False)
        chosen = [last] + sorted((rest[int(k)] for k in pick), reverse=True)
        norm = reference.fit_normalizer(self.inp.real_obs, self.inp.real_act)
        out = []
        for i in chosen:
            gen_state, idx_state, _ = self.records[i]
            idx_gen = torch.Generator(device=self.device)
            idx_gen.set_state(idx_state)
            gen = torch.Generator(device=self.device)
            gen.set_state(gen_state)
            start = self.inp.real_obs[inputs.start_indices(idx_gen, sz)]
            with torch.no_grad():
                out.append(reference.judge(self.inp, norm, self.ring, cursors[i], cursors[i + 1],
                                           start, gen, self.terminated))
        # the ring's count: every row written, up to its capacity
        stored = min(sz.capacity, sum(advance))
        out[0]["rows_wrong"] += abs(int(self.ring.num_stored) - stored)
        return out
