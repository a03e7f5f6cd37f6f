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
from mbrl_tpu_torch.util import profiling

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
        # under a mesh (parallel/): the loss is a sum of per-member terms and
        # takes `rows` and `regularize`; sampling takes a block of rows
        self.mesh_members = True
        self.mesh_rows = True
        self.mesh_particles = True

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
        the card, the kernels' tiles of the route it takes (the chain's, or
        the wide tensor-core route's for K1 and K2; K3's wide route reads the
        stack). With ``input_affine = (mean, std)``, the
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
        tiles = kernels.pack_tiles(stack) if stack.ws.device.type == "cuda" else None
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
        B % num_elites == 0. The forward is kernel K3; where it can
        (:meth:`_fuses_head`), K3 itself reads the rows through ``perm`` and
        writes the bounded head in the batch's order."""
        cached = self.packed(params)
        p = cached.view
        num_used = p["head"]["w"].shape[0]
        batch = x.shape[0]
        if self._fuses_head(cached, x, num_used):
            return self._forward_fused(cached, x, perm, num_used, None)
        kernels.HEAD_COUNTS["_forward_sharded.glue"] += 1
        h = self._permute_rows(x, perm, num_used)
        raw = kernels.fused_ensemble_mlp(h, cached.stack, tiles=cached.tiles)
        mean, logvar = self._bound(p, raw)
        mean = mean.reshape(batch, -1)
        if logvar is not None:
            logvar = logvar.reshape(batch, -1)
        return self._unpermute_rows(mean, logvar, perm, inv)

    def _sharded_draw(
        self,
        params: Params,
        x: torch.Tensor,
        perm: torch.Tensor,
        inv: Optional[torch.Tensor],
        draw_from: Optional[torch.Generator],
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """:meth:`_forward_sharded`, then :meth:`_draw`; where K3 finishes
        the head, it draws too, on normals drawn from ``draw_from`` before its
        launch (the same normals: nothing else draws in between)."""
        if draw_from is not None:
            cached = self.packed(params)
            num_used = cached.view["head"]["w"].shape[0]
            if self._fuses_head(cached, x, num_used):
                return self._forward_fused(cached, x, perm, num_used, draw_from)
        return self._draw(*self._forward_sharded(params, x, perm, inv), draw_from)

    def _forward_fused(
        self, cached: _Packed, x: torch.Tensor, perm: torch.Tensor, num_used: int,
        draw_from: Optional[torch.Generator],
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """K3 in the batch's order with the Gaussian head finished: ``(mean,
        logvar)``, or with ``draw_from`` the draw ``(mean + exp(logvar / 2) *
        N(0, 1), None)``, its normals drawn outside K3's span."""
        batch = x.shape[0]
        noise = None if draw_from is None else randn(draw_from, (batch, self.out_size), x.device)
        return kernels.fused_ensemble_mlp(
            x.reshape(num_used, batch // num_used, x.shape[-1]), cached.stack, tiles=cached.tiles,
            perm=perm, logvar_bounds=(cached.view["max_logvar"], cached.view["min_logvar"]),
            noise=noise)

    def _fuses_head(self, cached: _Packed, x: torch.Tensor, num_used: int) -> bool:
        """Whether K3 finishes this step's Gaussian head (:func:`kernels.k3_fuses_head`)."""
        if cached.tiles is None or not kernels.on_card(x):
            return False
        return kernels.k3_fuses_head(cached.tiles.layout, x.shape[0] // num_used, num_used,
                                     kernels.sm_count(x.device), not self.deterministic)

    @staticmethod
    def _draw(
        mean: torch.Tensor, logvar: Optional[torch.Tensor], generator: Optional[torch.Generator]
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(mean + exp(logvar / 2) * N(0, 1), None)`` with the normals drawn
        from ``generator``; ``(mean, logvar)`` unchanged without one, or
        without a logvar."""
        if generator is None or logvar is None:
            return mean, logvar
        std = torch.exp(0.5 * logvar)
        return mean + std * randn(generator, mean.shape, mean.device), None

    @profiling.span("GaussianMLP._permute_rows")
    def _permute_rows(self, x: torch.Tensor, perm: torch.Tensor, num_used: int) -> torch.Tensor:
        """Rows ``x[perm]`` as ``num_used`` equal contiguous shards, one a member."""
        batch = x.shape[0]
        return x[perm].reshape(num_used, batch // num_used, x.shape[-1]).float().contiguous()

    @profiling.span("GaussianMLP._unpermute_rows")
    def _unpermute_rows(
        self,
        mean: torch.Tensor,
        logvar: Optional[torch.Tensor],
        perm: torch.Tensor,
        inv: Optional[torch.Tensor],
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The shuffled rows back in the batch's order; ``inv`` is ``perm``'s
        inverse, computed here when not given."""
        if inv is None:
            batch = perm.shape[0]
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(batch, dtype=perm.dtype, device=perm.device)
        return mean[inv], None if logvar is None else logvar[inv]

    def _forward_split(
        self, params: Params, x: torch.Tensor, sharding, generator, propagation_indices,
        precomputed,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """:meth:`forward_propagated` of a batch whole on every rank of
        ``sharding`` (a data axis of more than one rank): each rank computes a
        share of the rows, and one all-reduce of zero-padded results gives the
        whole batch's on every rank. The propagation's draws are of the whole
        batch on every rank, as on one. With an equal shard for each elite, a
        rank runs its block of the elites, each on its own shard (K3 on those
        members alone); otherwise it runs its block of the rows through every
        elite, as the unsharded per-row fallback does."""
        mesh, axis = sharding.mesh, sharding.spec[0]
        parts, part = mesh.shape[axis], mesh.coords[axis]
        method = self.propagation_method
        num_used = int(params["elite"].shape[0])
        batch = x.shape[0]
        dev = x.device
        perm = idx = None
        if method == "random_model":
            if precomputed is not None:
                perm = precomputed[0]
            elif batch % num_used == 0:
                perm = randperm(generator, batch, dev)
            else:
                idx = randint(generator, 0, num_used, (batch,), dev)
        elif method == "fixed_model":
            if batch % num_used == 0:
                perm = propagation_indices
            else:
                idx = propagation_indices % num_used
        elif method != "expectation":
            raise ValueError(f"Invalid propagation method {method}.")
        if perm is not None:
            # slot p of the shuffled batch holds row perm[p] and is served by
            # member p // shard; this rank serves members [m0, m1)
            cached = self.packed(params)
            p = cached.view
            shard = batch // num_used
            m0, m1 = part * num_used // parts, (part + 1) * num_used // parts
            raw = x.new_zeros((batch, cached.stack.dims[-1]))
            if m1 > m0:
                slots = perm[m0 * shard:m1 * shard]
                h = x[slots].reshape(m1 - m0, shard, x.shape[-1]).float().contiguous()
                stack = dataclasses.replace(cached.stack, ws=cached.stack.ws[m0:m1],
                                            bs=cached.stack.bs[m0:m1])
                tiles = (None if cached.tiles is None
                         else dataclasses.replace(cached.tiles, w=cached.tiles.w[m0:m1]))
                out = kernels.fused_ensemble_mlp(h, stack, tiles=tiles)
                raw[slots] = out.reshape(-1, out.shape[-1])
            return self._bound(p, mesh.all_reduce(raw, (axis,)))
        # this rank's block of the rows through every elite
        block = mesh.block(batch, axis)
        mean, logvar = self.forward(params, x[block], use_only_elite=True)
        if idx is None:  # expectation
            mean, logvar = mean.mean(dim=0), None if logvar is None else logvar.mean(dim=0)
        else:
            gather = idx[block].reshape(1, -1, 1).expand(1, mean.shape[1], mean.shape[-1])
            mean = torch.gather(mean, 0, gather)[0]
            logvar = None if logvar is None else torch.gather(logvar, 0, gather)[0]
        local = mean if logvar is None else torch.cat([mean, logvar], dim=-1)
        whole = x.new_zeros((batch, local.shape[-1]))
        whole[block] = local
        whole = mesh.all_reduce(whole, (axis,))
        if logvar is None:
            return whole, None
        return whole[:, :mean.shape[-1]], whole[:, mean.shape[-1]:]

    def forward_propagated(
        self,
        params: Params,
        x: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        propagation_indices: Optional[torch.Tensor] = None,
        precomputed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        sharding=None,
        draw_from: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Rollout-time forward that collapses the ensemble axis per the
        propagation method (over elite members). ``x`` is (B, in); returns
        (B, out) mean/logvar. ``sharding`` (a ``parallel.mesh.Sharding`` of
        the rows over a data axis that divides B): the ranks split the work
        and each returns the whole batch's values (:meth:`_forward_split`).
        ``draw_from``: return the reparameterised draw ``(mean + exp(logvar /
        2) * N(0, 1), None)`` instead, the normals drawn from it after the
        propagation's own draws."""
        method = self.propagation_method
        if method is None or self.ensemble_size == 1:
            mean, logvar = self.forward(params, x)
            if self.ensemble_size == 1:
                mean, logvar = mean[0], None if logvar is None else logvar[0]
            return self._draw(mean, logvar, draw_from)
        if sharding is not None:
            if method == "random_model" and precomputed is None and generator is None:
                raise ValueError("random_model propagation requires a generator")
            if method == "fixed_model" and propagation_indices is None:
                raise ValueError("fixed_model propagation requires propagation_indices")
            return self._draw(*self._forward_split(params, x, sharding, generator,
                                                   propagation_indices, precomputed), draw_from)

        num_used = int(params["elite"].shape[0])
        batch = x.shape[0]
        shardable = batch % num_used == 0

        if method == "random_model":
            if precomputed is not None:
                return self._sharded_draw(params, x, *precomputed, draw_from)
            if generator is None:
                raise ValueError("random_model propagation requires a generator")
            if shardable:
                perm = randperm(generator, batch, x.device)
                return self._sharded_draw(params, x, perm, None, draw_from)
            idx = randint(generator, 0, num_used, (batch,), x.device)
        elif method == "fixed_model":
            if propagation_indices is None:
                raise ValueError("fixed_model propagation requires propagation_indices")
            if shardable:
                # persistent permutation => persistent member assignment (TSinf)
                return self._sharded_draw(params, x, propagation_indices, None, draw_from)
            idx = propagation_indices % num_used
        elif method == "expectation":
            mean, logvar = self.forward(params, x, use_only_elite=True)
            return self._draw(mean.mean(dim=0), None if logvar is None else logvar.mean(dim=0),
                              draw_from)
        else:
            raise ValueError(f"Invalid propagation method {method}.")

        mean, logvar = self.forward(params, x, use_only_elite=True)
        gather = idx.reshape(1, -1, 1).expand(1, batch, mean.shape[-1])
        m = torch.gather(mean, 0, gather)[0]
        lv = None if logvar is None else torch.gather(logvar, 0, gather)[0]
        return self._draw(m, lv, draw_from)

    # ------------------------------------------------------------------ #
    # Losses
    # ------------------------------------------------------------------ #
    def loss(
        self, params: Params, model_in: torch.Tensor, target: torch.Tensor,
        rows: Optional[Tuple[slice, int]] = None, regularize: bool = True,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Training loss over ``(E, B, in)/(E, B, out)`` (or 2-D, auto-lifted).

        Probabilistic: per-member Gaussian NLL (mean over batch and output dim,
        summed over members) + logvar-bound regularizer. Deterministic: summed
        squared error. A rank of a mesh passes its block of the members (the
        params' member leaves and the batch's first axis), ``rows`` = (its
        block of the batch's rows, the batch's row count), which the mean is
        over, and ``regularize`` False on all but one rank of the model axis."""
        if model_in.ndim == 2:
            model_in = model_in[None]
            target = target[None]
        mean, logvar = self.forward(params, model_in)
        if target.shape[0] != mean.shape[0]:
            target = target.expand(mean.shape)
        if self.deterministic:
            return torch.square(mean - target).sum(), {}
        nll_elem = torch.square(mean - target) * torch.exp(-logvar) + logvar
        if rows is None:
            nll = nll_elem.mean(dim=(1, 2)).sum()
        else:
            nll = nll_elem.sum() / (rows[1] * nll_elem.shape[-1])
        if regularize:
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
        pred, _ = self.forward_propagated(
            params,
            model_input,
            generator=generator,
            propagation_indices=model_state["propagation_indices"],
            precomputed=precomputed,
            sharding=model_state.get("sharding"),
            draw_from=None if deterministic or self.deterministic else generator,
        )
        return pred, model_state
