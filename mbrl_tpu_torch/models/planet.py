"""PlaNet: recurrent state-space world model from pixels (Hafner et al., 2019);
counterpart of ``mbrl_tpu/models/planet.py``.

A GRU belief h_t = f(h_{t-1}, s_{t-1}, a_{t-1}), prior p(s|h) and posterior
q(s|o,h) MLP heads with softplus + min_std, a conv pixel encoder and decoder, a
reward head on [h, s]; the loss is pixel MSE + reward MSE + a free-nats-clamped
KL. The model tracks a posterior for acting (``state["posterior"]``) and samples
the prior for latent planning, with the wrapper protocol ``ModelEnv`` and
``ModelTrainer`` drive (reset / prepare_rollout / sample / loss / eval_score).

Parameters are a plain dict of tensors in the JAX package's layout (linear
``w`` (d_in, d_out); the GRU's ``w_ih`` (in, 3h) and ``w_hh`` (h, 3h) in (r, z, n)
gate order, torch ``GRUCell`` semantics; convs as in ``conv_nets``), so
``save`` writes the same ``planet.pkl`` as the JAX package and ``load`` reads
either. Every draw takes an explicit ``torch.Generator``.

Layout of the unroll. The encoder does not depend on the recurrence, so it runs
once over all B·L frames before the loop; the decoder, the prior and the reward
heads run once over all steps after it. Only the belief GRU, the posterior head
and its draw stay a loop of L steps. The JAX package scans all of it and
rematerializes the decoder; at B = L = 50 the activations here are about a GB.

Precision. ``matmul_precision="highest"`` (the default) runs every convolution
and matmul of the model in full float32 (:func:`~mbrl_tpu_torch.device.full_float32`):
cuDNN would otherwise take TF32 on an H100, and the JAX package pins full
float32 because reduced-precision RSSM training diverged to NaN.
:meth:`PlaNetModel.precision` is the context; ``ModelTrainer`` runs the
backward pass inside it too.
"""
from __future__ import annotations

import contextlib
import math
import pathlib
import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mbrl_tpu_torch.device import (
    DeviceLike, full_float32, rand, randn, resolve_device, seed_words,
)
from mbrl_tpu_torch.models.conv_nets import Conv2dDecoder, Conv2dEncoder
from mbrl_tpu_torch.ops.tree import tree_map
from mbrl_tpu_torch.types import TransitionBatch

_PARAMS_FNAME = "planet.pkl"


def _xavier(generator, shape, device) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return rand(generator, shape, device) * (2 * bound) - bound


def _orthogonal(generator, shape, device) -> torch.Tensor:
    q, r = torch.linalg.qr(randn(generator, shape, "cpu"))
    return (q * torch.sign(torch.diagonal(r))).to(device)


def _linear_init(generator, in_f, out_f, device) -> Dict[str, torch.Tensor]:
    return {"w": _xavier(generator, (in_f, out_f), device),
            "b": torch.zeros((out_f,), device=device)}


def _linear(layer, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` over any leading dims, as one fused product."""
    out = torch.addmm(layer["b"], x.reshape(-1, x.shape[-1]), layer["w"])
    return out.reshape(*x.shape[:-1], out.shape[-1])


def _apply_mlp(layers, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = _linear(layer, x)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def _gru_init(generator, in_size, hid, device) -> Dict[str, torch.Tensor]:
    return {
        "w_ih": _xavier(generator, (in_size, 3 * hid), device),
        "w_hh": torch.cat([_orthogonal(generator, (hid, hid), device) for _ in range(3)], dim=1),
        "b_ih": torch.zeros((3 * hid,), device=device),
        "b_hh": torch.zeros((3 * hid,), device=device),
    }


def _gru_apply(p, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """torch ``GRUCell``: n = tanh(W_in x + b_in + r * (W_hn h + b_hn))."""
    gi = torch.addmm(p["b_ih"], x, p["w_ih"])
    gh = torch.addmm(p["b_hh"], h, p["w_hh"])
    hid = h.shape[-1]
    r, z = torch.sigmoid(gi[:, : 2 * hid] + gh[:, : 2 * hid]).chunk(2, dim=-1)
    n = torch.tanh(gi[:, 2 * hid :] + r * gh[:, 2 * hid :])
    return (1 - z) * n + z * h


class PlaNetModel:
    """RSSM world model with the TransitionRewardModel wrapper protocol
    (``ModelEnv`` takes its generic per-step loop: no shard-space rollout)."""

    def __init__(
        self,
        obs_shape: Tuple[int, int, int],
        obs_encoding_size: int,
        encoder_config,
        decoder_config,
        latent_state_size: int,
        action_size: int,
        belief_size: int,
        hidden_size_fcs: int,
        min_std: float = 0.1,
        free_nats: float = 3.0,
        kl_scale: float = 1.0,
        grad_clip_norm: float = 1000.0,
        matmul_precision: str = "highest",
        device: DeviceLike = "cuda",
    ):
        if matmul_precision not in ("highest", "default"):
            raise ValueError(f"matmul_precision {matmul_precision!r}: use 'highest' (full "
                             "float32) or 'default' (the caller's TF32 settings)")
        self.device = resolve_device(device)
        self.obs_shape = tuple(obs_shape)
        self.latent_state_size = latent_state_size
        self.action_size = action_size
        self.belief_size = belief_size
        self.hidden_size_fcs = hidden_size_fcs
        self.min_std = min_std
        self.free_nats = free_nats
        self.kl_scale = kl_scale
        self.grad_clip_norm = grad_clip_norm
        self.matmul_precision = matmul_precision
        self.num_elites = 1
        self.stochastic_loss = True  # the trainer passes a generator to loss()
        self.mesh_rows = True  # loss() takes a block of the batch's windows

        self.encoder = Conv2dEncoder(
            encoder_config, self.obs_shape[1:], obs_encoding_size, device=self.device
        )
        self.decoder = Conv2dDecoder(
            latent_state_size + belief_size, decoder_config[0], decoder_config[1],
            device=self.device,
        )
        self._obs_encoding_size = obs_encoding_size

    def __len__(self) -> int:
        return 1

    def precision(self):
        """The context every forward (and the trainer's backward) runs in."""
        if self.matmul_precision == "default":
            return contextlib.nullcontext()
        return full_float32()

    # ------------------------------------------------------------------ #
    # Params / state
    # ------------------------------------------------------------------ #
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        s, h, a, fc = (self.latent_state_size, self.belief_size, self.action_size,
                       self.hidden_size_fcs)
        dev = self.device
        params = {
            "belief_embed": _linear_init(generator, s + a, h, dev),
            "belief_gru": _gru_init(generator, h, h, dev),
            "prior": [_linear_init(generator, h, fc, dev), _linear_init(generator, fc, 2 * s, dev)],
            "encoder": self.encoder.init(generator),
            "posterior": [
                _linear_init(generator, self._obs_encoding_size + h, fc, dev),
                _linear_init(generator, fc, 2 * s, dev),
            ],
            "decoder": self.decoder.init(generator),
            "reward": [
                _linear_init(generator, h + s, fc, dev),
                _linear_init(generator, fc, fc, dev),
                _linear_init(generator, fc, 1, dev),
            ],
        }
        return self.reset_posterior({"params": params, "normalizer": None})

    # ------------------------------------------------------------------ #
    # Pieces
    # ------------------------------------------------------------------ #
    def _process_pixel_obs(self, obs: torch.Tensor) -> torch.Tensor:
        return obs.to(torch.float32) / 256.0 - 0.5

    def _belief(self, params, latent, action, belief):
        emb = torch.relu(_linear(params["belief_embed"], torch.cat([latent, action], dim=-1)))
        return _gru_apply(params["belief_gru"], emb, belief)

    def _mean_std(self, raw):
        mean = raw[..., : self.latent_state_size]
        std = F.softplus(raw[..., self.latent_state_size :]) + self.min_std
        return mean, std

    def _prior(self, params, belief):
        return self._mean_std(_apply_mlp(params["prior"], belief))

    def _posterior(self, params, belief, obs_encoding):
        return self._mean_std(
            _apply_mlp(params["posterior"], torch.cat([belief, obs_encoding], dim=-1))
        )

    def _reward(self, params, belief, latent):
        return _apply_mlp(params["reward"], torch.cat([belief, latent], dim=-1))

    def _decode(self, params, latent, belief):
        return self.decoder.apply(params["decoder"], torch.cat([latent, belief], dim=-1))

    def _normals(self, noise, generator, shape) -> torch.Tensor:
        if noise is not None:
            return torch.as_tensor(noise, dtype=torch.float32, device=self.device)
        if generator is None:
            raise ValueError("a stochastic unroll needs a generator or explicit noise")
        return randn(generator, shape, self.device)

    # ------------------------------------------------------------------ #
    # Training forward / loss
    # ------------------------------------------------------------------ #
    def unroll(
        self,
        params,
        next_obs: torch.Tensor,
        action: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        deterministic: bool = False,
        post_noise: Optional[torch.Tensor] = None,
        prior_noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Run the RSSM over a trajectory.

        next_obs: (B, L, C, H, W) already pixel-processed; action: (B, L, A).
        Returns a dict of (B, L, ...) stacks: prior/posterior (mean, std,
        sample), beliefs, reconstructions, predicted rewards.
        ``deterministic=True`` propagates posterior/prior means instead of
        samples. Otherwise the standard normals of the posterior and prior
        draws are ``post_noise`` and ``prior_noise`` (B, L, latent) when given,
        else drawn from ``generator`` (posterior first).
        """
        batch, length = next_obs.shape[:2]
        s = self.latent_state_size
        if not deterministic:
            post_noise = self._normals(post_noise, generator, (batch, length, s))
            prior_noise = self._normals(prior_noise, generator, (batch, length, s))
        with self.precision():
            enc = self.encoder.apply(
                params["encoder"], next_obs.reshape(batch * length, *next_obs.shape[2:])
            ).reshape(batch, length, -1)
            latent = torch.zeros((batch, s), device=self.device)
            belief = torch.zeros((batch, self.belief_size), device=self.device)
            beliefs, post_means, post_stds, post_samples = [], [], [], []
            for t in range(length):
                belief = self._belief(params, latent, action[:, t], belief)
                post_mean, post_std = self._posterior(params, belief, enc[:, t])
                latent = (post_mean if deterministic
                          else torch.addcmul(post_mean, post_std, post_noise[:, t]))
                beliefs.append(belief)
                post_means.append(post_mean)
                post_stds.append(post_std)
                post_samples.append(latent)
            beliefs = torch.stack(beliefs, dim=1)
            post_sample = torch.stack(post_samples, dim=1)
            prior_mean, prior_std = self._prior(params, beliefs)
            prior_sample = (prior_mean if deterministic
                            else torch.addcmul(prior_mean, prior_std, prior_noise))
            recon = self._decode(
                params, post_sample.reshape(batch * length, s),
                beliefs.reshape(batch * length, -1),
            ).reshape(batch, length, *next_obs.shape[2:])
            reward = self._reward(params, beliefs, post_sample)[..., 0]
        return {
            "prior_mean": prior_mean,
            "prior_std": prior_std,
            "prior_sample": prior_sample,
            "post_mean": torch.stack(post_means, dim=1),
            "post_std": torch.stack(post_stds, dim=1),
            "post_sample": post_sample,
            "belief": beliefs,
            "recon": recon,
            "reward": reward,
        }

    def loss(
        self,
        state: Dict[str, Any],
        batch: TransitionBatch,
        generator: Optional[torch.Generator] = None,
        post_noise: Optional[torch.Tensor] = None,
        prior_noise: Optional[torch.Tensor] = None,
        rows: Optional[Tuple[slice, int]] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """obs recon MSE (summed over CHW) + reward MSE + kl_scale * KL(q||p)
        with a free-nats clamp; means over batch and time. Without a
        generator or noise, draws from a generator seeded 0. A rank of a mesh
        passes its block of the windows and ``rows`` = (that block, the
        batch's window count): the noise of the whole batch is drawn and the
        block's kept, and the means are over the whole batch."""
        if generator is None and post_noise is None:
            generator = torch.Generator().manual_seed(0)
        if rows is not None and post_noise is None:
            block, total = rows
            shape = (total, batch.obs.shape[1] - 1, self.latent_state_size)
            post_noise = randn(generator, shape, self.device)[block]
            prior_noise = randn(generator, shape, self.device)[block]
        obs_l, rew_l, kl_l = self._per_sequence_losses(
            state, batch, generator, False, post_noise, prior_noise
        )
        if rows is None:
            obs_loss, reward_loss, kl_loss = obs_l.mean(), rew_l.mean(), kl_l.mean()
        else:
            obs_loss, reward_loss, kl_loss = (x.sum() / rows[1] for x in (obs_l, rew_l, kl_l))
        total = obs_loss + reward_loss + self.kl_scale * kl_loss
        meta = {"observations_loss": obs_loss, "reward_loss": reward_loss, "kl_loss": kl_loss}
        return total, meta

    def _per_sequence_losses(self, state, batch: TransitionBatch, generator, deterministic,
                             post_noise=None, prior_noise=None):
        """Per-sequence (B,) recon / reward / free-nats-KL components."""
        params = state["params"]
        dev = self.device
        obs = self._process_pixel_obs(torch.as_tensor(batch.obs, device=dev))
        action = torch.as_tensor(batch.act, dtype=torch.float32, device=dev)
        rewards = torch.as_tensor(batch.rewards, dtype=torch.float32, device=dev)

        outs = self.unroll(params, obs[:, 1:], action[:, :-1], generator,
                           deterministic=deterministic, post_noise=post_noise,
                           prior_noise=prior_noise)
        obs_l = torch.square(outs["recon"] - obs[:, 1:]).sum(dim=(2, 3, 4)).mean(dim=1)
        rew_l = torch.square(outs["reward"] - rewards[:, :-1]).mean(dim=1)
        # KL(N(post) || N(prior)) summed over the latent dim, clamped at free nats
        p_mean, p_std = outs["prior_mean"], outs["prior_std"]
        q_mean, q_std = outs["post_mean"], outs["post_std"]
        kl = (
            torch.log(p_std / q_std)
            + (torch.square(q_std) + torch.square(q_mean - p_mean)) / (2 * torch.square(p_std))
            - 0.5
        ).sum(dim=-1)
        kl_l = torch.clamp(kl, min=self.free_nats).mean(dim=1)
        return obs_l, rew_l, kl_l

    def eval_score(self, state: Dict[str, Any], batch: TransitionBatch):
        """Per-held-out-sequence validation score (1, B, 1): the deterministic
        (mean-propagated) recon + reward + KL loss of each window."""
        obs_l, rew_l, kl_l = self._per_sequence_losses(state, batch, None, True)
        per_seq = obs_l + rew_l + self.kl_scale * kl_l
        meta = {"observations_loss": obs_l.mean(), "reward_loss": rew_l.mean(),
                "kl_loss": kl_l.mean()}
        return per_seq[None, :, None], meta

    # ------------------------------------------------------------------ #
    # Acting: posterior tracking + prior sampling (ModelEnv protocol)
    # ------------------------------------------------------------------ #
    def update_posterior(
        self,
        state: Dict[str, Any],
        obs,
        action=None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        """Condition the tracked (s, h) on a new raw-pixel observation (and the
        action that produced it); action None starts an episode from zeros.
        Without a generator, draws from a generator seeded 0."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        dev = self.device
        obs = torch.as_tensor(np.asarray(obs), device=dev)[None]
        if action is None:
            latent = torch.zeros((1, self.latent_state_size), device=dev)
            belief = torch.zeros((1, self.belief_size), device=dev)
            action = torch.zeros((1, self.action_size), device=dev)
        else:
            action = torch.as_tensor(np.asarray(action), dtype=torch.float32,
                                     device=dev).reshape(1, -1)
            latent = state["posterior"]["latent"]
            belief = state["posterior"]["belief"]
        params = state["params"]
        with torch.no_grad(), self.precision():
            next_belief = self._belief(params, latent, action, belief)
            enc = self.encoder.apply(params["encoder"], self._process_pixel_obs(obs))
            post_mean, post_std = self._posterior(params, next_belief, enc)
            sample = torch.addcmul(post_mean, post_std,
                                   randn(generator, post_mean.shape, dev))
        return {**state, "posterior": {"latent": sample, "belief": next_belief}}

    def reset_posterior(self, state: Dict[str, Any]) -> Dict[str, Any]:
        return {
            **state,
            "posterior": {
                "latent": torch.zeros((1, self.latent_state_size), device=self.device),
                "belief": torch.zeros((1, self.belief_size), device=self.device),
            },
        }

    def reset(self, state: Dict[str, Any], obs: torch.Tensor, generator: torch.Generator):
        """The tracked posterior tiled to the planner's particle batch; the obs
        values are ignored."""
        batch = obs.shape[0]
        return {
            "latent": state["posterior"]["latent"].expand(batch, self.latent_state_size),
            "belief": state["posterior"]["belief"].expand(batch, self.belief_size),
        }

    def prepare_rollout(
        self, state: Dict[str, Any], model_state: Dict[str, Any], horizon: int,
        generator: torch.Generator,
    ) -> Dict[str, Any]:
        """Draw the whole rollout's prior normals (horizon, batch, latent) at
        once on the model's device, from a device generator seeded by
        ``generator``: one launch and no host copy per rollout, where a draw
        per step on the host generator costs a host draw and a copy each."""
        device_gen = torch.Generator(device=self.device).manual_seed(seed_words(generator, 1)[0])
        batch = model_state["latent"].shape[0]
        noise = randn(device_gen, (horizon, batch, self.latent_state_size), self.device)
        return {**model_state, "noise": noise, "step": 0}

    def sample(
        self,
        state: Dict[str, Any],
        act: torch.Tensor,
        model_state: Dict[str, Any],
        generator: torch.Generator,
        deterministic: bool = False,
    ):
        """One prior-transition step in latent space: (s, h, a) -> (s', r', h').
        The normals come from ``model_state`` after :meth:`prepare_rollout`,
        else from ``generator``."""
        params = state["params"]
        next_state = {k: v for k, v in model_state.items() if k not in ("latent", "belief")}
        with self.precision():
            next_belief = self._belief(params, model_state["latent"], act, model_state["belief"])
            prior_mean, prior_std = self._prior(params, next_belief)
            if deterministic:
                next_latent = prior_mean
            else:
                if "noise" in model_state:
                    eps = model_state["noise"][model_state["step"]]
                else:
                    eps = randn(generator, prior_mean.shape, self.device)
                next_latent = torch.addcmul(prior_mean, prior_std, eps)
            reward = self._reward(params, next_belief, next_latent)
        if "step" in model_state:
            next_state["step"] = model_state["step"] + 1
        next_state.update({"latent": next_latent, "belief": next_belief})
        return next_latent, reward, next_state

    def render(self, state: Dict[str, Any], latent: torch.Tensor, belief: torch.Tensor) -> np.ndarray:
        """Decode latents to uint8 images (B, H, W, C), for visualization."""
        with torch.no_grad(), self.precision():
            pred = self._decode(state["params"], latent, belief)
        img = 255.0 * torch.clamp(pred + 0.5, 0.0, 1.0)
        return img.cpu().numpy().transpose(0, 2, 3, 1).astype(np.uint8)

    # ------------------------------------------------------------------ #
    def update_normalizer(self, state, batch):
        return state

    def set_elite(self, state, elite):
        return state

    def save(self, state: Dict[str, Any], save_dir) -> None:
        """The params as numpy arrays, in the JAX package's file and layout."""
        host = tree_map(lambda t: t.detach().cpu().numpy(), state["params"])
        with open(pathlib.Path(save_dir) / _PARAMS_FNAME, "wb") as f:
            pickle.dump(host, f)

    def load(self, state: Dict[str, Any], load_dir) -> Dict[str, Any]:
        with open(pathlib.Path(load_dir) / _PARAMS_FNAME, "rb") as f:
            params = pickle.load(f)
        params = tree_map(
            lambda a: torch.as_tensor(np.array(a), dtype=torch.float32, device=self.device),
            params,
        )
        return {**state, "params": params}
