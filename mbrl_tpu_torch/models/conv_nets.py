"""Functional conv encoder and decoder for pixel observation models
(counterpart of ``mbrl_tpu/models/conv_nets.py``).

Parameters are plain dicts of tensors in the JAX package's layout: encoder
convs ``(out_ch, in_ch, k, k)`` (OIHW), decoder deconvs ``(in_ch, out_ch, k, k)``
(the layout of ``torch.nn.ConvTranspose2d``'s weight, which the JAX package
reads with ``lax.conv_transpose(..., transpose_kernel=True)``), linear layers
``(d_in, d_out)``. Padding is 0 (JAX's VALID). Randomness takes an explicit
``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mbrl_tpu_torch.device import DeviceLike, rand, resolve_device


def _xavier_uniform(generator, shape, fan_in, fan_out, device) -> torch.Tensor:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return rand(generator, shape, device) * (2 * bound) - bound


def _linear_init(generator, in_f, out_f, device) -> Dict[str, torch.Tensor]:
    return {
        "w": _xavier_uniform(generator, (in_f, out_f), in_f, out_f, device),
        "b": torch.zeros((out_f,), device=device),
    }


def conv_output_shape(image_shape: Tuple[int, int], layers_config) -> Tuple[int, int, int]:
    h, w = image_shape
    out_ch = layers_config[0][0]
    for in_ch, out_ch, k, s in layers_config:
        h = (h - k) // s + 1
        w = (w - k) // s + 1
    return out_ch, h, w


class Conv2dEncoder:
    """Conv stack + linear head (identity when flattened size == encoding_size)."""

    def __init__(
        self,
        layers_config: Sequence[Tuple[int, int, int, int]],
        image_shape: Tuple[int, int],
        encoding_size: int,
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
        device: DeviceLike = "cuda",
    ):
        self.layers_config = [tuple(c) for c in layers_config]
        self.image_shape = tuple(image_shape)
        self.encoding_size = encoding_size
        self.activation = activation
        self.device = resolve_device(device)
        c, h, w = conv_output_shape(self.image_shape, self.layers_config)
        self.cnn_out_size = c * h * w
        self.identity_head = self.cnn_out_size == encoding_size

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        dev = self.device
        convs = [
            {
                "w": _xavier_uniform(generator, (out_ch, in_ch, k, k), in_ch * k * k,
                                     out_ch * k * k, dev),
                "b": torch.zeros((out_ch,), device=dev),
            }
            for in_ch, out_ch, k, s in self.layers_config
        ]
        params: Dict[str, Any] = {"convs": convs}
        if not self.identity_head:
            params["fc"] = _linear_init(generator, self.cnn_out_size, self.encoding_size, dev)
        return params

    def apply(self, params, obs: torch.Tensor) -> torch.Tensor:
        """obs: (B, C, H, W) -> (B, encoding_size)."""
        h = obs
        for layer, (_, _, k, s) in zip(params["convs"], self.layers_config):
            h = self.activation(F.conv2d(h, layer["w"], layer["b"], stride=s))
        h = h.reshape(h.shape[0], -1)
        if not self.identity_head:
            h = h @ params["fc"]["w"] + params["fc"]["b"]
        return h


class Conv2dDecoder:
    """Linear layer + deconv stack; activation on all but the last deconv."""

    def __init__(
        self,
        encoding_size: int,
        deconv_input_shape: Tuple[int, int, int],
        layers_config: Sequence[Tuple[int, int, int, int]],
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
        device: DeviceLike = "cuda",
    ):
        self.encoding_size = encoding_size
        self.deconv_input_shape = tuple(deconv_input_shape)
        self.layers_config = [tuple(c) for c in layers_config]
        self.activation = activation
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        dev = self.device
        # the JAX package draws the deconvs first and the linear layer last
        deconvs = [
            {
                "w": _xavier_uniform(generator, (in_ch, out_ch, k, k), in_ch * k * k,
                                     out_ch * k * k, dev),
                "b": torch.zeros((out_ch,), device=dev),
            }
            for in_ch, out_ch, k, s in self.layers_config
        ]
        fc = _linear_init(generator, self.encoding_size, int(np.prod(self.deconv_input_shape)), dev)
        return {"fc": fc, "deconvs": deconvs}

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        """x: (B, encoding_size) -> (B, C_out, H, W); out_hw = (in_hw - 1) * s + k."""
        h = x @ params["fc"]["w"] + params["fc"]["b"]
        h = h.reshape(-1, *self.deconv_input_shape)
        n = len(self.layers_config)
        for i, (layer, (_, _, k, s)) in enumerate(zip(params["deconvs"], self.layers_config)):
            h = F.conv_transpose2d(h, layer["w"], layer["b"], stride=s)
            if i < n - 1:
                h = self.activation(h)
        return h
