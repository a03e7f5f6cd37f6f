"""Ensemble of any single-member model (counterpart of
``mbrl_tpu/models/basic_ensemble.py``).

The members share one architecture (the member model object); their params
are stacked on a leading ensemble axis, and the member forward and loss run
over that axis under ``torch.func.vmap``, as the JAX package vmaps them. The
forward of one-member ``GaussianMLP``s (``basic_ensemble.yaml``'s members)
runs as one ``GaussianMLP`` of that many members instead: the same batched
products that vmap makes, without its per-operation dispatch. Plain
PyTorch: the JAX package's ensemble reaches no Pallas kernel, so neither does
this one, and it offers no fast rollout (``ModelEnv`` takes its per-step loop).
Per-member customisation (e.g. mock members in tests) edits the stacked params.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from mbrl_tpu_torch.device import randint, randn
from mbrl_tpu_torch.models.gaussian_mlp import GaussianMLP
from mbrl_tpu_torch.ops.tree import tree_leaves_with_path, tree_map

Params = Dict[str, Any]


def _stack(trees: List[Any]) -> Any:
    """Trees of one structure as one tree whose leaves gain a leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees]) for i in range(len(first)))
    return torch.stack(trees)


def _as_member_stack(params: Params) -> Params:
    """One-member GaussianMLP params stacked on the ensemble axis, as the
    params of a GaussianMLP with that many members: each weight and bias
    drops its singleton member axis; the logvar bounds keep it, (E, 1, out),
    one pair per member."""
    def linear(layer):
        return {"w": layer["w"][:, 0], "b": layer["b"][:, 0]}

    out = {"layers": [linear(layer) for layer in params["layers"]], "head": linear(params["head"])}
    for key in ("min_logvar", "max_logvar"):
        if key in params:
            out[key] = params[key]
    return out


class BasicEnsemble:
    """Ensemble of any model: the member forward is vmapped over the stacked
    params' leading axis.

    The member must expose ``init(generator) -> params``,
    ``forward(params, x) -> (mean, logvar_or_None)``, ``loss`` and the
    attributes ``in_size``, ``out_size``, ``deterministic`` and ``device``.
    ``member_cfg`` is the name the YAML tree gives the member (an instantiated
    model arrives under it).
    """

    def __init__(
        self,
        ensemble_size: int,
        member_model=None,
        propagation_method: Optional[str] = None,
        member_cfg=None,
    ):
        if member_model is None:
            member_model = member_cfg
        if member_model is None:
            raise ValueError("BasicEnsemble requires a member model")
        self.ensemble_size = ensemble_size
        self.member = member_model
        self.propagation_method = propagation_method
        self.in_size = member_model.in_size
        self.out_size = member_model.out_size
        self.deterministic = member_model.deterministic
        # a one-member GaussianMLP evaluates a stack of members itself, in one
        # batched product a layer: its forward takes the stacked params as
        # they are (the same numbers as under vmap, far fewer launches)
        self._stacks_gaussian_mlp = (isinstance(member_model, GaussianMLP)
                                     and member_model.ensemble_size == 1)

    @property
    def device(self) -> torch.device:
        return self.member.device

    @property
    def num_members(self) -> int:
        return self.ensemble_size

    def __len__(self) -> int:
        return self.ensemble_size

    def init(self, generator: torch.Generator) -> Params:
        members = _stack([self.member.init(generator) for _ in range(self.ensemble_size)])
        return {"members": members,
                "elite": torch.arange(self.ensemble_size, dtype=torch.int64, device=self.device)}

    def num_elites(self, params: Params) -> int:
        return int(params["elite"].shape[0])

    def set_elite(self, params: Params, elite_indices) -> Params:
        # the reference ignores elites here; they are kept, as the JAX package keeps them
        new = dict(params)
        new["elite"] = torch.as_tensor(elite_indices, dtype=torch.int64, device=self.device)
        return new

    # ------------------------------------------------------------------ #
    def _member_forward_all(self, params: Params, x: torch.Tensor, use_only_elite: bool):
        member_params = params["members"]
        if use_only_elite and self.ensemble_size > 1:
            elite = params["elite"]
            member_params = tree_map(lambda leaf: leaf.index_select(0, elite), member_params)
        if self._stacks_gaussian_mlp:
            mean, logvar = self.member.forward(_as_member_stack(member_params), x)
            return mean, None if self.deterministic else logvar
        num_used = next(tree_leaves_with_path(member_params))[1].shape[0]
        xs = x.expand((num_used,) + tuple(x.shape)) if x.ndim == 2 else x

        def fwd(p, xi):
            mean, logvar = self.member.forward(p, xi)
            # a member that is itself a one-member ensemble returns a leading
            # singleton axis: collapse it, so the vmapped axis is the ensemble's
            if mean.ndim == 3:
                mean = mean[0]
                logvar = None if logvar is None else logvar[0]
            return mean, torch.zeros_like(mean) if logvar is None else logvar

        mean, logvar = torch.func.vmap(fwd)(member_params, xs)
        return mean, None if self.deterministic else logvar

    def forward(
        self, params: Params, x: torch.Tensor, use_only_elite: bool = False
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """All-member forward -> ``(E', B, out)`` mean and logvar."""
        return self._member_forward_all(params, x, use_only_elite)

    def forward_propagated(
        self,
        params: Params,
        x: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        propagation_indices: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Rollout-time forward over the elites, the ensemble axis collapsed by
        the propagation method: (B, in) -> (B, out)."""
        method = self.propagation_method
        if method is None:
            return self.forward(params, x)
        mean, logvar = self.forward(params, x, use_only_elite=True)
        num_used, batch = mean.shape[0], x.shape[0]
        if method == "random_model":
            if generator is None:
                raise ValueError("random_model propagation requires a generator")
            idx = randint(generator, 0, num_used, (batch,), x.device)
        elif method == "fixed_model":
            if propagation_indices is None:
                raise ValueError("fixed_model propagation requires propagation_indices")
            idx = propagation_indices % num_used
        elif method == "expectation":
            return mean.mean(dim=0), None if logvar is None else logvar.mean(dim=0)
        else:
            raise ValueError(f"Invalid propagation method {method}.")
        gather = idx.reshape(1, -1, 1).expand(1, batch, mean.shape[-1])
        m = torch.gather(mean, 0, gather)[0]
        lv = None if logvar is None else torch.gather(logvar, 0, gather)[0]
        return m, lv

    # ------------------------------------------------------------------ #
    def loss(self, params: Params, model_in: torch.Tensor, target: torch.Tensor):
        """The mean of the members' losses, computed under vmap."""
        if model_in.ndim == 2:
            model_in = model_in.expand((self.ensemble_size,) + tuple(model_in.shape))
            target = target.expand((self.ensemble_size,) + tuple(target.shape))

        def member_loss(p, mi, tg):
            return self.member.loss(p, mi, tg)[0]

        return torch.func.vmap(member_loss)(params["members"], model_in, target).mean(), {}

    def eval_score(self, params: Params, model_in: torch.Tensor, target: torch.Tensor):
        """Per-member squared error: ``(E, B, out)``."""
        with torch.no_grad():
            mean, _ = self.forward(params, model_in)
            return torch.square(mean - target.expand_as(mean)), {}

    # ------------------------------------------------------------------ #
    def sample_propagation_indices(
        self, batch_size: int, generator: torch.Generator
    ) -> torch.Tensor:
        return randint(generator, 0, self.ensemble_size, (batch_size,), self.device)

    def reset_1d(self, obs: torch.Tensor, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        batch = obs.shape[0]
        if self.propagation_method == "fixed_model":
            indices = self.sample_propagation_indices(batch, generator)
        else:
            indices = torch.zeros((batch,), dtype=torch.int64, device=obs.device)
        return {"obs": obs, "propagation_indices": indices}

    def sample_1d(
        self,
        params: Params,
        model_input: torch.Tensor,
        model_state: Dict[str, torch.Tensor],
        generator: torch.Generator,
        deterministic: bool = False,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        mean, logvar = self.forward_propagated(
            params, model_input, generator=generator,
            propagation_indices=model_state["propagation_indices"],
        )
        if deterministic or self.deterministic or logvar is None:
            return mean, model_state
        std = torch.exp(0.5 * logvar)
        return mean + std * randn(generator, mean.shape, mean.device), model_state
