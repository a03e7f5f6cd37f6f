"""Probabilistic ensemble MLP (counterpart of ``mbrl_tpu/models/gaussian_mlp.py``).

Parameters are a plain dict of tensors with the JAX package's layout
(``gaussian_mlp.py:122-154``): ``layers[i]["w"]`` (E, d_in, d_out),
``layers[i]["b"]`` (E, 1, d_out), ``head``, ``elite`` (int64 indices) and, unless
deterministic, ``min_logvar``/``max_logvar`` (1, out). Randomness takes an
explicit ``torch.Generator``.

``forward`` (the all-member broadcast forward, used by the ``expectation``
propagation and the per-row fallback) stays ``torch.matmul``; the equal-shard
forward ``_forward_sharded`` goes through kernel K3
(:func:`mbrl_tpu_torch.ops.kernels.fused_ensemble_mlp`) at any width: the
tensor-core chain up to 256 columns, the wide route beyond. The elite view and
its packed weights are kept per model state (:meth:`GaussianMLP.packed`), so a
rollout of steps, and every plan between two retrainings, packs once.

``loss`` and ``eval_score`` differentiate ``forward`` with ``torch.autograd``;
the trainable leaves are every float leaf but ``frozen_param_keys``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from mbrl_tpu_torch.device import DeviceLike, randint, randperm, randn, resolve_device
from mbrl_tpu_torch.ops import kernels
from mbrl_tpu_torch.ops.math import truncated_normal_init

Params = Dict[str, Any]

_ACTIVATIONS = kernels.ACTIVATIONS

LOGVAR_BOUND_WEIGHT = 0.01  # weight of the max/min logvar regularizer


def as_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(dtype)]


def fold_input_affine(mean: torch.Tensor, std: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor):
    """Fold ``(x - mean) / std`` into a first layer ``(w0, b0)``: an exact
    algebraic rewrite, in float32 whatever the dtype of ``mean`` and ``std``."""
    mu = mean.reshape(-1).float()
    sd = std.reshape(-1).float()
    w0f = w0 / sd[None, :, None]
    b0f = b0 - torch.einsum("i,eio->eo", mu / sd, w0)[:, None, :]
    return w0f, b0f


@dataclasses.dataclass(frozen=True)
class _Packed:
    """One model state's elite view and packed weights (``GaussianMLP.packed``).
    ``leaves`` holds the tensors the entry was packed from, so that none of
    them can be freed and its identity reused while the entry lives."""

    key: Tuple[Any, ...]
    leaves: Tuple[torch.Tensor, ...]
    view: Params
    stack: kernels.MLPStack
    tiles: Optional[kernels.ChainTiles]


class GaussianMLP:
    """Ensemble of Gaussian MLPs evaluated as one batched program.

    The head predicts ``2*out_size`` values (mean, raw logvar) unless
    ``deterministic``; logvar is soft-bounded between ``min_logvar`` and
    ``max_logvar``. ``compute_dtype="bfloat16"`` rounds the operands of every
    product to bf16 and accumulates in f32. ``rollout_shuffle`` picks the TS1
    re-shuffle of the fast rollout: ``"sort"`` (a fresh uniform permutation per
    step) or ``"rotate"`` (a random whole-batch rotation per step).
    """

    supports_fast_rollout = True

    def __init__(
        self,
        in_size: int,
        out_size: int,
        num_layers: int = 4,
        ensemble_size: int = 1,
        hid_size: int = 200,
        deterministic: bool = False,
        propagation_method: Optional[str] = None,
        learn_logvar_bounds: bool = False,
        activation: str = "relu",
        compute_dtype: Union[str, torch.dtype] = torch.float32,
        use_pallas: bool = False,
        pallas_tile: int = 512,
        rollout_shuffle: str = "sort",
        device: DeviceLike = "cuda",
    ):
        # `use_pallas`/`pallas_tile` select the JAX package's TPU kernels; they
        # are accepted so that its configs load, and ignored: on a CUDA device
        # the port always takes its kernels
        if rollout_shuffle not in ("sort", "rotate"):
            raise ValueError(
                f"rollout_shuffle must be 'sort' or 'rotate', got {rollout_shuffle!r}"
            )
        if activation not in _ACTIVATIONS:
            raise ValueError(
                f"Unknown activation {activation!r}; options: {sorted(_ACTIVATIONS)}"
            )
        self.device = resolve_device(device)
        self.in_size = in_size
        self.out_size = out_size
        self.num_layers = num_layers
        self.ensemble_size = ensemble_size
        self.hid_size = hid_size
        self.deterministic = deterministic
        self.propagation_method = propagation_method
        self.learn_logvar_bounds = learn_logvar_bounds
        # params left out of gradient updates
        self.frozen_param_keys = (
            () if (deterministic or learn_logvar_bounds) else ("min_logvar", "max_logvar")
        )
        self.activation_name = activation
        self.activation = _ACTIVATIONS[activation]
        self.compute_dtype = as_dtype(compute_dtype)
        self.rollout_shuffle = rollout_shuffle
        # the last params packed: one entry as they are, one with an input transform folded in
        self._packed: Dict[bool, _Packed] = {}
        self.packs = 0  # times `packed` had to pack anew

    # ------------------------------------------------------------------ #
    # Params
    # ------------------------------------------------------------------ #
    @property
    def num_members(self) -> int:
        return self.ensemble_size

    def __len__(self) -> int:
        return self.ensemble_size

    def init(self, generator: torch.Generator) -> Params:
        """Truncated-normal weights (std 1/(2*sqrt(fan_in))), zero biases,
        logvar bounds at (-10, 0.5), elites = all members."""
        e = self.ensemble_size
        dims = [self.in_size] + [self.hid_size] * self.num_layers
        head_out = self.out_size if self.deterministic else 2 * self.out_size
        dev = self.device
        layers = []
        for i in range(self.num_layers):
            layers.append(
                {
                    "w": truncated_normal_init(
                        generator, (e, dims[i], dims[i + 1]), fan_in=dims[i], device=dev
                    ),
                    "b": torch.zeros((e, 1, dims[i + 1]), device=dev),
                }
            )
        params: Params = {
            "layers": layers,
            "head": {
                "w": truncated_normal_init(
                    generator, (e, self.hid_size, head_out), fan_in=self.hid_size, device=dev
                ),
                "b": torch.zeros((e, 1, head_out), device=dev),
            },
            "elite": torch.arange(e, dtype=torch.int64, device=dev),
        }
        if not self.deterministic:
            params["min_logvar"] = -10.0 * torch.ones((1, self.out_size), device=dev)
            params["max_logvar"] = 0.5 * torch.ones((1, self.out_size), device=dev)
        return params

    def set_elite(self, params: Params, elite_indices) -> Params:
        new = dict(params)
        new["elite"] = torch.as_tensor(elite_indices, dtype=torch.int64, device=self.device)
        return new

    def _elite_view(self, params: Params) -> Params:
        """The elite members' weights (one gather per leaf)."""
        if self.ensemble_size == 1:
            return params
        elite = params["elite"]

        def take(leaf):
            return leaf.index_select(0, elite)

        view = {
            "layers": [{"w": take(l["w"]), "b": take(l["b"])} for l in params["layers"]],
            "head": {"w": take(params["head"]["w"]), "b": take(params["head"]["b"])},
            "elite": torch.arange(elite.shape[0], dtype=torch.int64, device=elite.device),
        }
        if not self.deterministic:
            view["min_logvar"] = params["min_logvar"]
            view["max_logvar"] = params["max_logvar"]
        return view

    def pack(self, p: Params) -> kernels.MLPStack:
        """The kernels' packed weight stack of a (viewed) params dict."""
        return kernels.pack_mlp(
            [l["w"] for l in p["layers"]],
            [l["b"] for l in p["layers"]],
            p["head"]["w"],
            p["head"]["b"],
            self.activation_name,
            dtype=self.compute_dtype,
        )

    def packed(
        self, params: Params, input_affine: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    ) -> _Packed:
        """The elite view of ``params`` with its packed weight stack and, on
        the card, the chain route's tiles (none for a stack that takes the
        wide route). With ``input_affine = (mean, std)``, the
        caller's input transform ``(x - mean) / std`` is folded into the first
        layer, an exact algebraic rewrite, and the stack takes raw inputs. Kept
        for as long as ``params`` (and the transform) hold the same tensors,
        unchanged (identity and in-place version of every leaf) and the model
        the same dtype and activation, so the steps of a rollout and the plans
        between two retrainings pack once; ``set_elite``, new weights, a new
        transform or an in-place update pack anew."""
        leaves = [params["elite"], params["head"]["w"], params["head"]["b"]]
        for layer in params["layers"]:
            leaves += [layer["w"], layer["b"]]
        if not self.deterministic:
            leaves += [params["min_logvar"], params["max_logvar"]]
        folded = input_affine is not None
        if folded:
            leaves += list(input_affine)
        key = (self.compute_dtype, self.activation_name, tuple(t._version for t in leaves))
        hit = self._packed.get(folded)
        if (hit is not None and hit.key == key and len(hit.leaves) == len(leaves)
                and all(a is b for a, b in zip(hit.leaves, leaves))):
            return hit
        view = self._elite_view(params)
        if folded:
            w0, b0 = fold_input_affine(
                *input_affine, view["layers"][0]["w"].float(), view["layers"][0]["b"]
            )
            first = {"w": w0, "b": b0}
            stack = self.pack({**view, "layers": [first] + list(view["layers"][1:])})
        else:
            stack = self.pack(view)
        chain = kernels.takes_chain(stack.dims, stack.low_precision)
        tiles = kernels.pack_chain(stack) if chain and stack.ws.device.type == "cuda" else None
        entry = _Packed(key, tuple(leaves), view, stack, tiles)
        self._packed[folded] = entry
        self.packs += 1
        return entry

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #
    def _round(self, h: torch.Tensor) -> torch.Tensor:
        # bf16 operands with f32 accumulation, as JAX's preferred_element_type
        if self.compute_dtype == torch.float32:
            return h.float()
        return h.to(self.compute_dtype).float()

    def _bound(self, p: Params, out: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if self.deterministic:
            return out, None
        mean = out[..., : self.out_size]
        logvar = kernels.bound_logvar(out[..., self.out_size :], p["max_logvar"], p["min_logvar"])
        return mean, logvar

    def forward(
        self, params: Params, x: torch.Tensor, use_only_elite: bool = False
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """All-member forward: ``x`` (B, in) broadcast to every member, or
        (E, B, in). Returns ``(mean, logvar)`` of shape (E', B, out); logvar is
        None when deterministic."""
        p = self._elite_view(params) if use_only_elite else params
        h = self._round(x)
        for layer in p["layers"]:
            h = torch.matmul(h, self._round(layer["w"])) + layer["b"]
            h = self._round(self.activation(h))
        out = torch.matmul(h, self._round(p["head"]["w"])) + p["head"]["b"]
        return self._bound(p, out)

    def _forward_sharded(
        self,
        params: Params,
        x: torch.Tensor,
        perm: torch.Tensor,
        inv: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Equal-shard propagation: permute the batch, give each elite member an
        equal contiguous shard, forward, un-permute. Requires
        B % num_elites == 0. The forward is kernel K3."""
        cached = self.packed(params)
        p = cached.view
        num_used = p["head"]["w"].shape[0]
        batch = x.shape[0]
        h = x[perm].reshape(num_used, batch // num_used, x.shape[-1]).float().contiguous()
        raw = kernels.fused_ensemble_mlp(h, cached.stack, tiles=cached.tiles)
        mean, logvar = self._bound(p, raw)
        mean = mean.reshape(batch, -1)
        if logvar is not None:
            logvar = logvar.reshape(batch, -1)
        if inv is None:
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(batch, dtype=perm.dtype, device=perm.device)
        return mean[inv], None if logvar is None else logvar[inv]

    def forward_propagated(
        self,
        params: Params,
        x: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        propagation_indices: Optional[torch.Tensor] = None,
        precomputed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Rollout-time forward that collapses the ensemble axis per the
        propagation method (over elite members). ``x`` is (B, in); returns
        (B, out) mean/logvar."""
        method = self.propagation_method
        if method is None or self.ensemble_size == 1:
            mean, logvar = self.forward(params, x)
            if self.ensemble_size == 1:
                return mean[0], None if logvar is None else logvar[0]
            return mean, logvar

        num_used = int(params["elite"].shape[0])
        batch = x.shape[0]
        shardable = batch % num_used == 0

        if method == "random_model":
            if precomputed is not None:
                return self._forward_sharded(params, x, *precomputed)
            if generator is None:
                raise ValueError("random_model propagation requires a generator")
            if shardable:
                perm = randperm(generator, batch, x.device)
                return self._forward_sharded(params, x, perm)
            idx = randint(generator, 0, num_used, (batch,), x.device)
        elif method == "fixed_model":
            if propagation_indices is None:
                raise ValueError("fixed_model propagation requires propagation_indices")
            if shardable:
                # persistent permutation => persistent member assignment (TSinf)
                return self._forward_sharded(params, x, propagation_indices)
            idx = propagation_indices % num_used
        elif method == "expectation":
            mean, logvar = self.forward(params, x, use_only_elite=True)
            return mean.mean(dim=0), None if logvar is None else logvar.mean(dim=0)
        else:
            raise ValueError(f"Invalid propagation method {method}.")

        mean, logvar = self.forward(params, x, use_only_elite=True)
        gather = idx.reshape(1, -1, 1).expand(1, batch, mean.shape[-1])
        m = torch.gather(mean, 0, gather)[0]
        lv = None if logvar is None else torch.gather(logvar, 0, gather)[0]
        return m, lv

    # ------------------------------------------------------------------ #
    # Losses
    # ------------------------------------------------------------------ #
    def loss(
        self, params: Params, model_in: torch.Tensor, target: torch.Tensor
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Training loss over ``(E, B, in)/(E, B, out)`` (or 2-D, auto-lifted).

        Probabilistic: per-member Gaussian NLL (mean over batch and output dim,
        summed over members) + logvar-bound regularizer. Deterministic: summed
        squared error."""
        if model_in.ndim == 2:
            model_in = model_in[None]
            target = target[None]
        if target.shape[0] != self.ensemble_size:
            target = target.expand((self.ensemble_size,) + tuple(target.shape[1:]))
        mean, logvar = self.forward(params, model_in)
        if self.deterministic:
            return torch.square(mean - target).sum(), {}
        nll_elem = torch.square(mean - target) * torch.exp(-logvar) + logvar
        nll = nll_elem.mean(dim=(1, 2)).sum()
        nll = nll + LOGVAR_BOUND_WEIGHT * (
            params["max_logvar"].sum() - params["min_logvar"].sum()
        )
        return nll, {}

    def eval_score(
        self, params: Params, model_in: torch.Tensor, target: torch.Tensor
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Per-member squared error on un-bootstrapped data: ``(E, B, out)``."""
        with torch.no_grad():
            mean, _ = self.forward(params, model_in)
            return torch.square(mean - target.expand_as(mean)), {}

    # ------------------------------------------------------------------ #
    # Simulation contract (used via TransitionRewardModel by ModelEnv)
    # ------------------------------------------------------------------ #
    def sample_propagation_indices(
        self, batch_size: int, generator: torch.Generator
    ) -> torch.Tensor:
        """Persistent batch permutation for TSinf (fixed_model) propagation."""
        return randperm(generator, batch_size, self.device)

    def reset_1d(self, obs: torch.Tensor, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        batch = obs.shape[0]
        if self.propagation_method == "fixed_model":
            indices = self.sample_propagation_indices(batch, generator)
        else:
            indices = torch.zeros((batch,), dtype=torch.int64, device=obs.device)
        return {"obs": obs, "propagation_indices": indices}

    def prepare_rollout(
        self,
        params: Params,
        model_state: Dict[str, Any],
        horizon: int,
        generator: torch.Generator,
    ) -> Dict[str, Any]:
        """Precompute all per-step TS1 permutations (and their inverses) for a
        fixed-horizon rollout."""
        if self.propagation_method != "random_model":
            return model_state
        batch = model_state["obs"].shape[0]
        num_used = int(params["elite"].shape[0])
        if self.ensemble_size == 1 or batch % num_used != 0:
            return model_state
        dev = model_state["obs"].device
        perms = torch.stack([randperm(generator, batch, dev) for _ in range(horizon)])
        cols = torch.arange(batch, dtype=perms.dtype, device=dev).expand_as(perms)
        invs = torch.empty_like(perms).scatter_(1, perms, cols)
        return {**model_state, "rollout_perms": perms, "rollout_invs": invs, "rollout_t": 0}

    def sample_1d(
        self,
        params: Params,
        model_input: torch.Tensor,
        model_state: Dict[str, Any],
        generator: torch.Generator,
        deterministic: bool = False,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One transition: propagated Gaussian head, reparameterized draw."""
        precomputed = None
        if "rollout_perms" in model_state:
            t = min(model_state["rollout_t"], model_state["rollout_perms"].shape[0] - 1)
            precomputed = (model_state["rollout_perms"][t], model_state["rollout_invs"][t])
            model_state = {**model_state, "rollout_t": model_state["rollout_t"] + 1}
        mean, logvar = self.forward_propagated(
            params,
            model_input,
            generator=generator,
            propagation_indices=model_state["propagation_indices"],
            precomputed=precomputed,
        )
        if deterministic or self.deterministic or logvar is None:
            return mean, model_state
        std = torch.exp(0.5 * logvar)
        return mean + std * randn(generator, mean.shape, mean.device), model_state
