"""Weight bridge: the JAX ``TransitionRewardModel`` state, as numpy arrays, to
the port's state on a given device.

Input layout (``mbrl_tpu/models/gaussian_mlp.py:122-154``)::

    {"params": {"layers": [{"w": (E, d_in, d_out), "b": (E, 1, d_out)}, ...],
                "head": {"w": (E, hid, head_out), "b": (E, 1, head_out)},
                "elite": (n_elite,) int,
                "min_logvar": (1, out), "max_logvar": (1, out)},   # unless deterministic
     "normalizer": None | object or mapping with "mean"/"std" (1, in_size)}

Every leaf is a numpy array (e.g. ``jax.tree_util.tree_map(np.asarray, state)``);
this module never sees JAX.

A ``BasicEnsemble``'s params (``mbrl_tpu/models/basic_ensemble.py:60-63``) are
``{"members": <the member's params, each leaf stacked on a leading ensemble
axis>, "elite": (n_elite,) int}``; with ``GaussianMLP`` members
(``ensemble_size: 1``) a member leaf keeps the singleton member axis, e.g.
``members.layers[i].w`` (E, 1, d_in, d_out). :func:`convert_params` takes that
tree as it is (float leaves float32, integer leaves int64).

:func:`convert_sac_state` does the same for the JAX package's ``SACState``
(``mbrl_tpu/planning/sac.py:53-62``): networks, log-alpha and the update
counter, and the three optax Adam states (``mu``, ``nu``, ``count``) as
``torch.optim.Adam``'s ``exp_avg``, ``exp_avg_sq`` and ``step``, so that both
packages can be stepped from one mid-training state.

:func:`convert_planet_state` turns the JAX package's ``PlaNetModel`` state
(``mbrl_tpu/models/planet.py:141-174``) into the port's: the encoder convs
(OIHW) and optional head, the decoder's linear layer and deconvs
((in_ch, out_ch, k, k)), ``belief_embed``, the GRU (``w_ih`` (in, 3h),
``w_hh`` (h, 3h), gates (r, z, n)), the prior, posterior and reward MLPs, and
the tracked posterior. Both packages keep this layout, so the converter
checks it and changes no array.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from mbrl_tpu_torch.device import DeviceLike, resolve_device
from mbrl_tpu_torch.models.gaussian_mlp import as_dtype
from mbrl_tpu_torch.ops.normalizer import NormalizerState
from mbrl_tpu_torch.ops.tree import tree_map


def _tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device).to(dtype).contiguous()


def _field(obj, name: str):
    """A field of a mapping or of an object (a dataclass or a named tuple)."""
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def convert_basic_ensemble_params(params: Mapping[str, Any], device: DeviceLike = "cuda"
                                  ) -> Dict[str, Any]:
    """BasicEnsemble params (numpy leaves) → the port's, in the same layout:
    floating leaves float32, integer leaves (the elites) int64."""
    dev = resolve_device(device)

    def leaf(x):
        x = np.asarray(x)
        return _tensor(x, dev, torch.float32 if np.issubdtype(x.dtype, np.floating) else torch.int64)

    return {"members": tree_map(leaf, params["members"]), "elite": _tensor(params["elite"], dev, torch.int64)}


def convert_params(
    params: Mapping[str, Any], device: DeviceLike = "cuda", compute_dtype=None
) -> Dict[str, Any]:
    """GaussianMLP params (numpy leaves) → the port's params dict. With
    ``compute_dtype``, the weight stack (layer and head weights) is cast to it;
    biases and logvar bounds stay float32. BasicEnsemble params (a
    ``"members"`` tree) go to :func:`convert_basic_ensemble_params`."""
    if "members" in params:
        return convert_basic_ensemble_params(params, device)
    dev = resolve_device(device)
    wdt = torch.float32 if compute_dtype is None else as_dtype(compute_dtype)
    out: Dict[str, Any] = {
        "layers": [
            {"w": _tensor(l["w"], dev, wdt), "b": _tensor(l["b"], dev)}
            for l in params["layers"]
        ],
        "head": {"w": _tensor(params["head"]["w"], dev, wdt), "b": _tensor(params["head"]["b"], dev)},
        "elite": _tensor(params["elite"], dev, torch.int64),
    }
    for key in ("min_logvar", "max_logvar"):
        if key in params:
            out[key] = _tensor(params[key], dev)
    return out


def convert_state(
    state: Mapping[str, Any], device: DeviceLike = "cuda", compute_dtype=None
) -> Dict[str, Any]:
    """JAX ``TransitionRewardModel`` state (numpy leaves) → the port's state."""
    dev = resolve_device(device)
    normalizer: Optional[NormalizerState] = None
    if state.get("normalizer") is not None:
        n = state["normalizer"]
        # float64 statistics (PETS' normalize_double_precision) stay float64
        double = np.asarray(_field(n, "mean")).dtype == np.float64
        sdt = torch.float64 if double else torch.float32
        normalizer = NormalizerState(
            mean=_tensor(_field(n, "mean"), dev, sdt),
            std=_tensor(_field(n, "std"), dev, sdt),
            eps=1e-12 if double else 1e-5,
        )
    return {
        "params": convert_params(state["params"], dev, compute_dtype),
        "normalizer": normalizer,
    }


def _linear(sd: Dict[str, np.ndarray], name: str, w, b) -> None:
    """A JAX (d_in, d_out) layer as ``nn.Linear``'s (d_out, d_in) weight."""
    sd[f"{name}.weight"] = np.asarray(w).T
    sd[f"{name}.bias"] = np.asarray(b)


def _sac_policy_dict(tree, act_dim: int, gaussian: bool) -> Dict[str, np.ndarray]:
    """The JAX policy layout (a list of three {"w", "b"}; the Gaussian head is
    [mean | log_std] in one matrix) as the port's policy state dict; the Adam
    moments share the layout."""
    sd: Dict[str, np.ndarray] = {}
    for name, layer in zip(("linear1", "linear2"), tree[:2]):
        _linear(sd, name, layer["w"], layer["b"])
    w, b = np.asarray(tree[2]["w"]), np.asarray(tree[2]["b"])
    if gaussian:
        _linear(sd, "mean_linear", w[:, :act_dim], b[:act_dim])
        _linear(sd, "log_std_linear", w[:, act_dim:], b[act_dim:])
    else:
        _linear(sd, "mean", w, b)
    return sd


def _sac_critic_dict(tree) -> Dict[str, np.ndarray]:
    """The JAX twin critic ({"q1": [3 layers], "q2": [3 layers]}) as the
    port's ``QNetwork`` state dict (linear1-3, linear4-6)."""
    sd: Dict[str, np.ndarray] = {}
    for i, layer in enumerate(list(tree["q1"]) + list(tree["q2"])):
        _linear(sd, f"linear{i + 1}", layer["w"], layer["b"])
    return sd


def _adam_part(opt_state):
    """optax.adam's ``ScaleByAdamState`` (count, mu, nu) inside its chain state."""
    parts = opt_state if isinstance(opt_state, (tuple, list)) else [opt_state]
    for part in parts:
        if (isinstance(part, Mapping) and "mu" in part) or hasattr(part, "mu"):
            return part
    raise ValueError("no Adam state (mu, nu, count) in the optimizer state")


def _load_adam(opt: torch.optim.Optimizer, module_params, opt_state, to_dict) -> None:
    """Adam's per-parameter state from optax's: ``to_dict`` maps the moments'
    tree to {parameter name: array}."""
    adam = _adam_part(opt_state)
    mu, nu = to_dict(_field(adam, "mu")), to_dict(_field(adam, "nu"))
    step = float(np.asarray(_field(adam, "count")))
    for name, p in module_params:
        opt.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": torch.as_tensor(np.array(mu[name]), dtype=p.dtype, device=p.device),
            "exp_avg_sq": torch.as_tensor(np.array(nu[name]), dtype=p.dtype, device=p.device),
        }


def convert_sac_state(sac, state):
    """JAX ``SACState`` (numpy leaves; a dataclass or a mapping of its fields)
    → the port's :class:`~mbrl_tpu_torch.planning.sac.SACState` for ``sac``
    (a port ``SAC`` of the same sizes), optimizer moments included."""
    gaussian = sac.policy_type == "Gaussian"
    policy, critic, critic_target = sac._modules()

    def as_tensors(sd):
        return {k: torch.as_tensor(np.array(v), dtype=torch.float32) for k, v in sd.items()}

    def policy_dict(tree):
        return _sac_policy_dict(tree, sac.act_dim, gaussian)

    policy.load_state_dict(as_tensors(policy_dict(_field(state, "policy"))))
    critic.load_state_dict(as_tensors(_sac_critic_dict(_field(state, "critic"))))
    critic_target.load_state_dict(as_tensors(_sac_critic_dict(_field(state, "critic_target"))))
    out = sac._state(policy, critic, critic_target,
                     log_alpha=float(np.asarray(_field(state, "log_alpha"))),
                     updates=int(np.asarray(_field(state, "updates"))))
    _load_adam(out.policy_opt, policy.named_parameters(), _field(state, "policy_opt"), policy_dict)
    _load_adam(out.critic_opt, critic.named_parameters(), _field(state, "critic_opt"),
               _sac_critic_dict)
    _load_adam(out.alpha_opt, [("log_alpha", out.log_alpha)], _field(state, "alpha_opt"),
               lambda x: {"log_alpha": x})
    return out


def _planet_linear(layer, dev) -> Dict[str, torch.Tensor]:
    w, b = np.asarray(layer["w"]), np.asarray(layer["b"])
    if w.ndim != 2 or b.shape != (w.shape[1],):
        raise ValueError(f"a linear layer's w must be (d_in, d_out) with b (d_out,); got "
                         f"{w.shape} and {b.shape}")
    return {"w": _tensor(w, dev), "b": _tensor(b, dev)}


def _planet_conv(layer, dev, out_axis: int) -> Dict[str, torch.Tensor]:
    w, b = np.asarray(layer["w"]), np.asarray(layer["b"])
    if w.ndim != 4 or b.shape != (w.shape[out_axis],):
        raise ValueError(f"a conv weight must be 4-D with a bias per output channel (axis "
                         f"{out_axis}); got {w.shape} and {b.shape}")
    return {"w": _tensor(w, dev), "b": _tensor(b, dev)}


def convert_planet_params(params: Mapping[str, Any], device: DeviceLike = "cuda") -> Dict[str, Any]:
    """JAX PlaNet params (numpy leaves) → the port's params dict."""
    dev = resolve_device(device)

    def mlp(layers):
        return [_planet_linear(l, dev) for l in layers]

    enc = params["encoder"]
    encoder: Dict[str, Any] = {"convs": [_planet_conv(c, dev, 0) for c in enc["convs"]]}
    if "fc" in enc:
        encoder["fc"] = _planet_linear(enc["fc"], dev)
    gru = {k: np.asarray(params["belief_gru"][k]) for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
    hid = gru["w_hh"].shape[0]
    if (gru["w_hh"].shape != (hid, 3 * hid) or gru["w_ih"].shape[1] != 3 * hid
            or gru["b_ih"].shape != (3 * hid,) or gru["b_hh"].shape != (3 * hid,)):
        raise ValueError("belief_gru must hold w_ih (in, 3h), w_hh (h, 3h), b_ih and b_hh (3h,); "
                         f"got {({k: v.shape for k, v in gru.items()})}")
    return {
        "belief_embed": _planet_linear(params["belief_embed"], dev),
        "belief_gru": {k: _tensor(v, dev) for k, v in gru.items()},
        "prior": mlp(params["prior"]),
        "encoder": encoder,
        "posterior": mlp(params["posterior"]),
        "decoder": {
            "fc": _planet_linear(params["decoder"]["fc"], dev),
            "deconvs": [_planet_conv(c, dev, 1) for c in params["decoder"]["deconvs"]],
        },
        "reward": mlp(params["reward"]),
    }


def convert_planet_state(state: Mapping[str, Any], device: DeviceLike = "cuda") -> Dict[str, Any]:
    """JAX ``PlaNetModel`` state (numpy leaves) → the port's state, with its
    tracked posterior; the optimizer state is not carried over."""
    dev = resolve_device(device)
    return {
        "params": convert_planet_params(state["params"], dev),
        "normalizer": None,
        "posterior": {k: _tensor(state["posterior"][k], dev) for k in ("latent", "belief")},
    }
