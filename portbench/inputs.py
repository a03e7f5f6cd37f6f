"""What the benchmark makes from ``--seed`` and hands, the same, to the program
and to the reference: the ensemble's and the policy's weights, the elite
members and a synthetic real replay buffer. Everything is drawn on the device,
from one generator, in a few large calls. Nothing here imports the port.

The weights stand in for a trained model, so they follow the recipe of the
configuration's ``assumed.weights``: the ensemble's weights normal with std
1/(2 sqrt(fan_in)) clipped at 2 std (the port's PETS initialisation), its
biases normal, the log-variance half of the head's bias at a constant (a
trained model predicts a small variance); the policy's weights uniform in
+-1/sqrt(fan_in) (its initialisation) and normal biases. The columns in
``still_columns`` (those a termination predicate reads) get no weights and
no mean bias: their next value is the last one plus the draw alone, so the
share of rows that terminate, and with it the work of a masked write, is the
same for every seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch


@dataclasses.dataclass
class Sizes:
    obs: int
    act: int
    hid: int
    layers: int
    members: int
    elites: int
    policy_hidden: int
    start_states: int
    horizon: int
    capacity: int
    real_rows: int

    @property
    def model_in(self) -> int:
        return self.obs + self.act

    @property
    def model_out(self) -> int:  # the next observation's delta and the learned reward
        return self.obs + 1


def sizes(config: Dict, traffic: Dict, scale: Optional[Dict] = None) -> Sizes:
    """The cell's sizes from its configuration and its traffic; ``scale``
    replaces some of them, for runs at a toy size on the CPU only."""
    ov, dm = config["overrides"], config["dynamics_model"]
    trains_per_epoch = math.ceil(ov["epoch_length"] / ov["freq_train_model"])
    s = Sizes(
        obs=config["env"]["obs_dim"], act=config["env"]["act_dim"], hid=dm["hid_size"],
        layers=dm["num_layers"], members=dm["ensemble_size"], elites=ov["num_elites"],
        policy_hidden=ov["sac_hidden_size"], start_states=traffic["start_states"],
        horizon=traffic["horizon"],
        # mbpo.py: rollout length x rollout batch x retrainings an epoch x epochs retained
        capacity=(traffic["horizon"] * ov["effective_model_rollouts_per_step"]
                  * ov["freq_train_model"] * trains_per_epoch
                  * ov["num_epochs_to_retain_sac_buffer"]),
        real_rows=config["synthetic_buffer"]["rows"],
    )
    return dataclasses.replace(s, **(scale or {}))


@dataclasses.dataclass
class Inputs:
    sizes: Sizes
    layer_w: List[torch.Tensor]  # (E, d_in, d_out), the head last
    layer_b: List[torch.Tensor]  # (E, 1, d_out)
    min_logvar: torch.Tensor  # (1, out)
    max_logvar: torch.Tensor
    elite: torch.Tensor  # (elites,) int64, member k of a TS1 shard is elite[k]
    policy_w: List[torch.Tensor]  # (d_in, d_out): linear1, linear2, mean, log_std
    policy_b: List[torch.Tensor]
    action_low: torch.Tensor  # (act,)
    action_high: torch.Tensor
    real_obs: torch.Tensor  # (rows, obs) f32
    real_act: torch.Tensor  # (rows, act) f32


def _split(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
    out, at = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(flat[at:at + n].reshape(shape))
        at += n
    return out


def make(config: Dict, sz: Sizes, seed: int, device) -> Inputs:
    rec = config["assumed"]["weights"]
    g = torch.Generator(device=device).manual_seed(seed % 2**63)
    e, out = sz.members, sz.model_out
    dims = [sz.model_in] + [sz.hid] * sz.layers + [2 * out]
    w_shapes = [(e, a, b) for a, b in zip(dims[:-1], dims[1:])]
    b_shapes = [(e, 1, b) for b in dims[1:]]
    flat = torch.randn(sum(math.prod(s) for s in w_shapes + b_shapes), generator=g,
                       device=device)
    parts = _split(flat, w_shapes + b_shapes)
    layer_w = [torch.clamp(w, -2.0, 2.0) / (2.0 * math.sqrt(s[1]))
               for w, s in zip(parts[:len(w_shapes)], w_shapes)]
    layer_b = [b * rec["hidden_bias_std"] for b in parts[len(w_shapes):]]
    head_b = layer_b[-1]
    head_b[..., :out] *= rec["head_mean_bias_std"] / rec["hidden_bias_std"]
    head_b[..., out:] = rec["head_logvar_bias"]
    for col in rec.get("still_columns", []):
        # a column the termination predicate reads moves by the draw alone, so
        # that every seed terminates the same share of rows
        layer_w[-1][..., [col, out + col]] = 0.0
        head_b[..., col] = 0.0

    pdims = [(sz.obs, sz.policy_hidden), (sz.policy_hidden, sz.policy_hidden),
             (sz.policy_hidden, sz.act), (sz.policy_hidden, sz.act)]
    pflat = torch.rand(sum(a * b for a, b in pdims), generator=g, device=device)
    policy_w = [(2.0 * w - 1.0) / math.sqrt(s[0]) for w, s in zip(_split(pflat, pdims), pdims)]
    bflat = torch.randn(sum(b for _, b in pdims), generator=g, device=device)
    policy_b = [b * rec["policy_bias_std"] for b in _split(bflat, [(b,) for _, b in pdims])]

    env = config["env"]
    low = torch.full((sz.act,), float(env["action_low"]), device=device)
    high = torch.full((sz.act,), float(env["action_high"]), device=device)
    buf = config["synthetic_buffer"]
    mu, sd = buf["obs_normal"]
    real_obs = torch.randn((sz.real_rows, sz.obs), generator=g, device=device) * sd + mu
    u = torch.rand((sz.real_rows, sz.act + len(buf["obs_uniform"])), generator=g, device=device)
    real_act = low + (high - low) * u[:, :sz.act]
    for j, (col, (lo, hi)) in enumerate(sorted(buf["obs_uniform"].items())):
        real_obs[:, int(col)] = lo + (hi - lo) * u[:, sz.act + j]
    elite = torch.randperm(e, generator=g, device=device)[:sz.elites]
    return Inputs(
        sizes=sz, layer_w=layer_w, layer_b=layer_b,
        min_logvar=torch.full((1, out), float(rec["min_logvar"]), device=device),
        max_logvar=torch.full((1, out), float(rec["max_logvar"]), device=device),
        elite=elite, policy_w=policy_w, policy_b=policy_b, action_low=low, action_high=high,
        real_obs=real_obs, real_act=real_act)


def start_indices(generator: torch.Generator, sz: Sizes) -> torch.Tensor:
    """One rollout's start states, as rows of the real buffer: uniform, with
    replacement (the real replay buffer's ``sample``)."""
    return torch.randint(0, sz.real_rows, (sz.start_states,), generator=generator,
                         device=generator.device)
