"""Soft Actor-Critic learner (counterpart of ``mbrl_tpu/planning/sac.py``).

Twin-Q critic, tanh-squashed Gaussian policy with its log-prob correction, a
deterministic policy variant, soft target updates at an interval, optional
automatic entropy tuning, checkpoints, and the reference's pranz24 ``sac.pth``
loader. The networks are ``nn.Module``s named as the reference's pranz24
networks (``linear1``, ``linear2``, ``mean_linear``, ``log_std_linear``;
``linear1``–``linear6``), so a reference checkpoint loads with
``load_state_dict``.

The learner's state is one :class:`SACState` (modules, log-alpha, three Adam
optimizers with optax's defaults, the update counter on the device). Where the
JAX package returns a new state, :meth:`SAC.update_parameters` updates the
state it is given in place and returns it. The update keeps the JAX package's
order exactly: the critic's target from the pre-update policy, target critics
and alpha; the policy loss through the updated critic; the alpha loss on the
policy loss's log-probabilities; then the counter and the soft target update.
Randomness comes from a ``torch.Generator`` on the learner's device, and every
standard normal the learner draws comes through :func:`normal`.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import pickle
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mbrl_tpu_torch.device import DeviceLike, resolve_device
from mbrl_tpu_torch.ops import kernels
from mbrl_tpu_torch.ops.tree import tree_map
from mbrl_tpu_torch.planning.core import Agent
from mbrl_tpu_torch.util import profiling
from mbrl_tpu_torch.util.device_buffer import DeviceReplayBuffer, uniform_indices

LOG_SIG_MAX = 2.0
LOG_SIG_MIN = -20.0
EPS = 1e-6

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def normal(generator: torch.Generator, shape: Sequence[int], device: torch.device) -> torch.Tensor:
    """Standard normals for the policy's samples: every draw of the learner
    comes through here (in order: the next action of the critic's target, then
    the policy loss's action, per update)."""
    return torch.randn(tuple(shape), generator=generator, device=generator.device).to(device)


class GaussianPolicy(nn.Module):
    """Two ReLU layers, then a mean and a log-std head (clipped).

    One forward, two routes by what the call shows: on the card, without
    grad and at :data:`kernels.POLICY_KERNEL_ROWS` rows or more (MBPO's
    imagined rollout), the policy kernel (:func:`kernels.fused_policy_mlp`,
    weights packed once per weight state, :meth:`packed`); every other call
    (the SAC update, its next action at batch 256, an acting step, the CPU)
    the ``nn.Linear`` layers, counted in ``fused_policy_mlp.linear``."""

    _pack: Optional[Tuple[tuple, "kernels.PolicyPack"]] = None

    def __init__(self, num_inputs: int, act_dim: int, hidden_size: int):
        super().__init__()
        self.linear1 = nn.Linear(num_inputs, hidden_size)
        self.linear2 = nn.Linear(hidden_size, hidden_size)
        self.mean_linear = nn.Linear(hidden_size, act_dim)
        self.log_std_linear = nn.Linear(hidden_size, act_dim)

    def __getstate__(self):
        # a copy (SACAgent's acting clone, a pickle) packs its own weights
        state = dict(super().__getstate__())
        state.pop("_pack", None)
        return state

    def _layers(self) -> Tuple[nn.Linear, ...]:
        return self.linear1, self.linear2, self.mean_linear, self.log_std_linear

    def takes_kernel(self, obs: torch.Tensor) -> bool:
        """Whether :meth:`forward` runs ``obs`` through the policy kernel."""
        return (kernels.on_card(obs) and not torch.is_grad_enabled() and obs.dtype == torch.float32
                and obs.dim() >= 1 and obs.numel() >= kernels.POLICY_KERNEL_ROWS * obs.shape[-1]
                and kernels.policy_supported(self.linear1.in_features,
                                             self.linear1.out_features,
                                             self.mean_linear.out_features))

    def packed(self) -> "kernels.PolicyPack":
        """The weights in the policy kernel's layout, packed again only when a
        parameter was replaced or written in place (an optimizer step,
        ``load_state_dict``): the cache is keyed on each parameter's
        ``data_ptr()`` and ``_version``."""
        params = [p for layer in self._layers() for p in (layer.weight, layer.bias)]
        key = tuple((p.data_ptr(), p._version) for p in params)
        if self._pack is None or self._pack[0] != key:
            self._pack = (key, kernels.pack_policy(*params))
        return self._pack[1]

    @profiling.span("GaussianPolicy.forward")
    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if self.takes_kernel(obs):
            lead = obs.shape[:-1]
            mean, log_std = kernels.fused_policy_mlp(obs.reshape(-1, obs.shape[-1]).contiguous(),
                                                     self.packed())
            return mean.reshape(*lead, -1), log_std.reshape(*lead, -1)
        kernels.fused_policy_mlp.linear += 1
        x = F.relu(self.linear2(F.relu(self.linear1(obs))))
        log_std = torch.clamp(self.log_std_linear(x), LOG_SIG_MIN, LOG_SIG_MAX)
        return self.mean_linear(x), log_std


class DeterministicPolicy(nn.Module):
    """Two ReLU layers and a mean head; exploration noise is added outside."""

    def __init__(self, num_inputs: int, act_dim: int, hidden_size: int):
        super().__init__()
        self.linear1 = nn.Linear(num_inputs, hidden_size)
        self.linear2 = nn.Linear(hidden_size, hidden_size)
        self.mean = nn.Linear(hidden_size, act_dim)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self.mean(F.relu(self.linear2(F.relu(self.linear1(obs))))), None


class QNetwork(nn.Module):
    """Twin Q chains: linear1-3 and linear4-6, each ReLU, ReLU, linear."""

    def __init__(self, num_inputs: int, act_dim: int, hidden_size: int):
        super().__init__()
        d = num_inputs + act_dim
        self.linear1 = nn.Linear(d, hidden_size)
        self.linear2 = nn.Linear(hidden_size, hidden_size)
        self.linear3 = nn.Linear(hidden_size, 1)
        self.linear4 = nn.Linear(d, hidden_size)
        self.linear5 = nn.Linear(hidden_size, hidden_size)
        self.linear6 = nn.Linear(hidden_size, 1)

    def forward(self, obs: torch.Tensor, act: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([obs, act], dim=-1)
        q1 = self.linear3(F.relu(self.linear2(F.relu(self.linear1(x)))))
        q2 = self.linear6(F.relu(self.linear5(F.relu(self.linear4(x)))))
        return q1, q2


def _init_linears(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's ``_mlp_init``: weights uniform in +-1/sqrt(fan_in),
    biases zero (drawn on the generator's device, then moved)."""
    with torch.no_grad():
        for layer in module.children():
            fan_out, fan_in = layer.weight.shape
            bound = 1.0 / math.sqrt(fan_in)
            w = torch.rand((fan_out, fan_in), generator=generator, device=generator.device)
            layer.weight.copy_((2 * w - 1) * bound)
            layer.bias.zero_()


def _adam(params, lr: float) -> torch.optim.Adam:
    """optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8, no eps_root)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


@dataclasses.dataclass
class SACState:
    policy: nn.Module
    critic: QNetwork
    critic_target: QNetwork
    log_alpha: torch.Tensor  # 0-d leaf, requires grad
    policy_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    alpha_opt: torch.optim.Adam
    updates: torch.Tensor  # 0-d int64 counter on the device


class SAC:
    """Twin-Q SAC with a tanh-Gaussian (or deterministic) policy on ``device``."""

    def __init__(
        self,
        num_inputs: int,
        action_space,
        gamma: float = 0.99,
        tau: float = 0.005,
        alpha: float = 0.2,
        policy: str = "Gaussian",
        target_update_interval: int = 1,
        automatic_entropy_tuning: bool = True,
        hidden_size: int = 256,
        lr: float = 3e-4,
        target_entropy: Optional[float] = None,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.num_inputs = num_inputs
        self.act_dim = action_space.shape[0]
        self.gamma = gamma
        self.tau = tau
        self.init_alpha = alpha
        self.policy_type = policy
        self.target_update_interval = target_update_interval
        self.automatic_entropy_tuning = automatic_entropy_tuning and policy == "Gaussian"
        self.hidden_size = hidden_size
        self.lr = lr
        if target_entropy is None:
            target_entropy = -float(self.act_dim)
        self.target_entropy = float(target_entropy)
        low = np.asarray(action_space.low, np.float32)
        high = np.asarray(action_space.high, np.float32)
        self.action_scale = torch.as_tensor((high - low) / 2.0, device=self.device)
        self.action_bias = torch.as_tensor((high + low) / 2.0, device=self.device)

    # ------------------------------------------------------------------ #
    # State
    # ------------------------------------------------------------------ #
    def _modules(self) -> Tuple[nn.Module, QNetwork, QNetwork]:
        cls = GaussianPolicy if self.policy_type == "Gaussian" else DeterministicPolicy
        h = self.hidden_size
        return (cls(self.num_inputs, self.act_dim, h).to(self.device),
                QNetwork(self.num_inputs, self.act_dim, h).to(self.device),
                QNetwork(self.num_inputs, self.act_dim, h).to(self.device))

    def _state(self, policy: nn.Module, critic: QNetwork, critic_target: QNetwork,
               log_alpha: Optional[float] = None, updates: int = 0) -> SACState:
        """A state around these modules, with fresh optimizers."""
        log_alpha = math.log(self.init_alpha) if log_alpha is None else log_alpha
        la = torch.tensor(log_alpha, dtype=torch.float32, device=self.device, requires_grad=True)
        return SACState(
            policy=policy, critic=critic, critic_target=critic_target, log_alpha=la,
            policy_opt=_adam(policy.parameters(), self.lr),
            critic_opt=_adam(critic.parameters(), self.lr), alpha_opt=_adam([la], self.lr),
            updates=torch.tensor(updates, dtype=torch.int64, device=self.device),
        )

    def init(self, generator: torch.Generator) -> SACState:
        """Fresh networks (``_init_linears``), the target a copy of the critic."""
        policy, critic, critic_target = self._modules()
        for module in (policy, critic):
            _init_linears(module, generator)
        critic_target.load_state_dict(critic.state_dict())
        return self._state(policy, critic, critic_target)

    # ------------------------------------------------------------------ #
    # Policy
    # ------------------------------------------------------------------ #
    def _sample_action(
        self, policy: nn.Module, obs: torch.Tensor, generator: torch.Generator
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Reparameterized tanh-Gaussian sample -> (action, log_prob, mean_action)."""
        mean, log_std = policy(obs)
        if log_std is None:  # deterministic policy with clipped exploration noise
            noise = torch.clamp(normal(generator, mean.shape, mean.device) * 0.1, -0.25, 0.25)
            action = torch.tanh(mean) * self.action_scale + self.action_bias
            noisy = torch.minimum(torch.maximum(action + noise, self.action_bias - self.action_scale),
                                  self.action_bias + self.action_scale)
            return noisy, torch.zeros(mean.shape[:-1] + (1,), device=mean.device), action
        std = torch.exp(log_std)
        x = mean + std * normal(generator, mean.shape, mean.device)
        y = torch.tanh(x)
        action = y * self.action_scale + self.action_bias
        # Gaussian log-prob with the tanh-squash correction
        logp = -0.5 * (torch.square((x - mean) / std) + 2 * log_std + math.log(2 * math.pi))
        logp = logp - torch.log(self.action_scale * (1 - torch.square(y)) + EPS)
        logp = logp.sum(dim=-1, keepdim=True)
        mean_action = torch.tanh(mean) * self.action_scale + self.action_bias
        return action, logp, mean_action

    @profiling.span("SAC.act_tensor")
    def act_tensor(self, policy: nn.Module, obs: torch.Tensor, generator: torch.Generator,
                   sample: bool = True) -> torch.Tensor:
        with torch.no_grad():
            action, _, mean_action = self._sample_action(policy, obs, generator)
        return action if sample else mean_action

    def select_action(
        self, state: SACState, obs: np.ndarray, generator: torch.Generator, evaluate: bool = False
    ) -> np.ndarray:
        obs = torch.as_tensor(np.asarray(obs), dtype=torch.float32, device=self.device)
        squeeze = obs.ndim == 1
        if squeeze:
            obs = obs[None]
        act = self.act_tensor(state.policy, obs, generator, sample=not evaluate).cpu().numpy()
        return act[0] if squeeze else act

    # ------------------------------------------------------------------ #
    # Updates
    # ------------------------------------------------------------------ #
    def update_parameters(
        self, state: SACState, batch: Batch, generator: torch.Generator
    ) -> Tuple[SACState, Dict[str, torch.Tensor]]:
        """One SAC update from a (obs, act, next_obs, reward, mask) device
        batch (``mask`` is 1 - terminated), in place; metrics stay on the
        device."""
        obs, act, next_obs, reward, mask = batch
        alpha = state.log_alpha.detach().exp()

        # --- critic ---
        with torch.no_grad():
            next_action, next_logp, _ = self._sample_action(state.policy, next_obs, generator)
            q1_t, q2_t = state.critic_target(next_obs, next_action)
            min_q_next = torch.minimum(q1_t, q2_t) - alpha * next_logp
            target_q = reward + mask * self.gamma * min_q_next
        q1, q2 = state.critic(obs, act)
        critic_loss = torch.mean(torch.square(q1 - target_q)) + torch.mean(torch.square(q2 - target_q))
        state.critic_opt.zero_grad(set_to_none=True)
        critic_loss.backward()
        state.critic_opt.step()

        # --- policy, through the updated critic ---
        pi, logp, _ = self._sample_action(state.policy, obs, generator)
        q1_pi, q2_pi = state.critic(obs, pi)
        policy_loss = torch.mean(alpha * logp - torch.minimum(q1_pi, q2_pi))
        params = list(state.policy.parameters())
        for p, g in zip(params, torch.autograd.grad(policy_loss, params)):
            p.grad = g
        state.policy_opt.step()

        # --- alpha, on the policy loss's log-probabilities ---
        if self.automatic_entropy_tuning:
            alpha_loss = -torch.mean(state.log_alpha * (logp.detach() + self.target_entropy))
            state.alpha_opt.zero_grad(set_to_none=True)
            alpha_loss.backward()
            state.alpha_opt.step()
        else:
            alpha_loss = torch.zeros((), device=self.device)

        # --- counter, then the soft target update (tau 0 between intervals),
        # both on the device: (1 - tau) target + tau critic ---
        state.updates += 1
        tau = (state.updates % self.target_update_interval == 0).to(torch.float32) * self.tau
        with torch.no_grad():
            targets = list(state.critic_target.parameters())
            torch._foreach_mul_(targets, 1 - tau)
            torch._foreach_add_(targets, torch._foreach_mul(list(state.critic.parameters()), tau))
        metrics = {"critic_loss": critic_loss.detach(), "policy_loss": policy_loss.detach(),
                   "alpha_loss": alpha_loss.detach(), "alpha": alpha}
        return state, metrics

    def update_many(
        self, state: SACState, batches: Batch, generator: torch.Generator
    ) -> Tuple[SACState, Dict[str, torch.Tensor]]:
        """One update per leading index of the stacked batches; the metrics'
        means."""
        runs = []
        for i in range(batches[0].shape[0]):
            state, m = self.update_parameters(state, tuple(b[i] for b in batches), generator)
            runs.append(m)
        return state, {k: torch.stack([m[k] for m in runs]).mean() for k in runs[0]}

    def update_from_buffer(
        self, state: SACState, buf_state, generator: torch.Generator, num_updates: int,
        batch_size: int,
    ) -> Tuple[SACState, Dict[str, torch.Tensor]]:
        """``num_updates`` updates on batches drawn from a device buffer state
        (``util.device_buffer.DeviceBufferState``): indices uniform in
        ``[0, max(num_stored, 1))`` drawn on the device, never read back."""
        idx = uniform_indices(generator, (num_updates, batch_size), buf_state.num_stored)
        return self.update_many(state, DeviceReplayBuffer.gather(buf_state, idx), generator)

    # ------------------------------------------------------------------ #
    # Persistence
    # ------------------------------------------------------------------ #
    def state_to_host(self, state: SACState) -> Dict[str, Any]:
        """The state as nested dicts of numpy arrays and numbers (a checkpoint
        leaf tree): modules' and optimizers' state dicts."""
        def host(x):
            return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x

        return tree_map(host, {
            "policy": state.policy.state_dict(),
            "critic": state.critic.state_dict(),
            "critic_target": state.critic_target.state_dict(),
            "log_alpha": state.log_alpha,
            "policy_opt": state.policy_opt.state_dict(),
            "critic_opt": state.critic_opt.state_dict(),
            "alpha_opt": state.alpha_opt.state_dict(),
            "updates": state.updates,
        })

    def state_from_host(self, host: Dict[str, Any]) -> SACState:
        """Inverse of :meth:`state_to_host` (leaves numpy arrays or tensors)."""
        def tensor(x):
            return torch.as_tensor(np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x))

        def opt_state(sd):
            out = dict(sd)
            out["state"] = {int(k): {n: tensor(v) for n, v in s.items()}
                            for k, s in sd["state"].items()}
            return out

        policy, critic, critic_target = self._modules()
        for module, key in ((policy, "policy"), (critic, "critic"),
                            (critic_target, "critic_target")):
            module.load_state_dict({k: tensor(v) for k, v in host[key].items()})
        state = self._state(policy, critic, critic_target, float(np.asarray(host["log_alpha"])),
                            int(np.asarray(host["updates"])))
        for opt, key in ((state.policy_opt, "policy_opt"), (state.critic_opt, "critic_opt"),
                         (state.alpha_opt, "alpha_opt")):
            opt.load_state_dict(opt_state(host[key]))
        return state

    def save_checkpoint(self, state: SACState, ckpt_path) -> None:
        with open(ckpt_path, "wb") as f:
            pickle.dump(self.state_to_host(state), f)

    def load_checkpoint(self, ckpt_path) -> SACState:
        """A checkpoint that :meth:`save_checkpoint` wrote, or the ``sac.pkl``
        of the JAX package's SAC (carried across by
        :func:`mbrl_tpu_torch.convert.convert_sac_state`, Adam moments included)."""
        from mbrl_tpu_torch.convert import convert_sac_state, load_jax_pickle

        host = load_jax_pickle(ckpt_path)
        if isinstance(host, dict):
            return self.state_from_host(host)
        return convert_sac_state(self, host)

    def load_torch_checkpoint(self, ckpt_path) -> SACState:
        """A reference-format checkpoint (``{policy,critic,critic_target}_state_dict``
        of the pranz24 modules, mbrl/third_party/pytorch_sac_pranz24/sac.py:176-192)
        loaded into fresh modules; alpha and the optimizers start fresh."""
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        policy, critic, critic_target = self._modules()
        policy.load_state_dict(ckpt["policy_state_dict"])
        critic.load_state_dict(ckpt["critic_state_dict"])
        critic_target.load_state_dict(ckpt["critic_target_state_dict"])
        return self._state(policy, critic, critic_target)


class SACAgent(Agent):
    """The SAC learner behind the Agent.act API, acting on the learner's device.

    It acts with a clone of the policy: :meth:`set_state` clones the newest
    policy when no clone is waiting, and ``act`` swaps the waiting clone in
    once it has waited ``refresh_age`` acts. With ``refresh_age == 1`` the
    policy used at step t+1 reflects every update through step t (the
    reference's interleaving); larger values let the policy lag by up to
    about twice that many steps.
    """

    def __init__(self, sac: SAC, state: SACState, seed: int = 0, refresh_age: int = 1):
        self.sac = sac
        self.state = state
        self._refresh_age = max(int(refresh_age), 1)
        self._generator = torch.Generator(device=sac.device).manual_seed(seed)
        self._policy: Optional[nn.Module] = None
        self._pending: Optional[nn.Module] = None
        self._pending_age = 0

    def set_state(self, state: SACState) -> None:
        self.state = state
        if self._pending is None:
            self._pending = copy.deepcopy(state.policy)
            self._pending_age = 0

    def _current_policy(self) -> nn.Module:
        if self._policy is None:  # the first act
            if self._pending is None:
                self._pending = copy.deepcopy(self.state.policy)
            self._policy, self._pending = self._pending, None
        elif self._pending is not None:
            self._pending_age += 1
            if self._pending_age >= self._refresh_age:
                self._policy, self._pending = self._pending, None
        return self._policy

    def act(self, obs: np.ndarray, sample: bool = False, batched: bool = False,
            **kwargs) -> np.ndarray:
        policy = self._current_policy()
        obs = torch.as_tensor(np.asarray(obs), dtype=torch.float32, device=self.sac.device)
        squeeze = obs.ndim == 1
        if squeeze:
            obs = obs[None]
        act = self.sac.act_tensor(policy, obs, self._generator, sample=sample).cpu().numpy()
        return act[0] if squeeze else act
