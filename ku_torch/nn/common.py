"""Shared helpers for the StyleGAN layers (port of ``ku/nn/common.py``):
activations by name, Keras' truncated normal, the equalized-LR runtime
coefficient and ``normalize_tuple``."""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
from torch import nn
from torch.nn import functional as F

Activation = Optional[Union[str, Callable]]

_ACTIVATIONS = {
    "relu": F.relu,
    "leaky_relu": lambda x: leaky_relu(x, 0.2),
    "lrelu": lambda x: leaky_relu(x, 0.2),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "softplus": F.softplus,
    "swish": F.silu,
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation.
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu,
    "linear": lambda x: x,
    None: lambda x: x,
}


def resolve_activation(activation: Activation) -> Callable:
    if callable(activation):
        return activation
    try:
        return _ACTIVATIONS[activation]
    except KeyError:
        raise ValueError(f"unknown activation {activation!r}")


def truncated_normal_init(stddev: float):
    """TruncatedNormal(mean=0, stddev) cut at ±2σ (Keras semantics), as
    ``init(shape, generator=None, device=None, dtype=None)``.

    The equalized-LR layers draw their kernels at stddev 1/lrmul."""

    def init(shape, generator: Optional[torch.Generator] = None, device=None,
             dtype=None):
        w = torch.empty(shape, device=device, dtype=dtype)
        return nn.init.trunc_normal_(w, std=stddev, a=-2.0 * stddev,
                                     b=2.0 * stddev, generator=generator)

    return init


def equalized_coeff(gain: float, lrmul: float, fan_in) -> float:
    """Runtime kernel coefficient ``gain / sqrt(fan_in) * lrmul``, where
    ``ku`` takes ``fan_in`` as the product of ALL non-batch input dims,
    spatial dims included."""
    return gain / math.sqrt(fan_in) * lrmul


def leaky_relu(x, negative_slope: float = 0.01):
    """``jax.nn.leaky_relu`` (flax's ``nn.leaky_relu``): ``where(x >= 0, x,
    slope·x)``, so its gradient at 0 is 1, where ``F.leaky_relu``'s is the
    slope. A pre-activation of exactly 0 is common behind zero inputs and
    zero biases (pix2pix's masked centre)."""
    return torch.where(x >= 0, x, negative_slope * x)


def normalize_tuple(value, rank: int):
    if isinstance(value, int):
        return (value,) * rank
    value = tuple(value)
    if len(value) != rank:
        raise ValueError(f"expected {rank} values, got {value!r}")
    return value
