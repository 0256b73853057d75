"""Initializer extensions (port of ``ku/initializers_ext/initializers.py``).

``he_normal(scale)`` is VarianceScaling(scale, mode='fan_in',
distribution='truncated_normal'), as ``jax.nn.initializers``
computes it: fans from the last two axes times the receptive field (the
product of the others), a normal cut at ±2 and rescaled to unit variance.
The initializer is a callable ``(shape, generator=None, device=None,
dtype=None)``; its draws differ from JAX's, its distribution is the same.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

# The standard deviation of N(0, 1) cut at ±2.
_TRUNC_STD = 0.87962566103423978


def fan_in(shape) -> float:
    """jax's fan-in: ``shape[-2]`` times the product of ``shape[:-2]``."""
    if len(shape) < 2:
        raise ValueError(f"a fan-in needs a weight of 2 or more axes, got {shape}")
    return shape[-2] * math.prod(shape[:-2])


def variance_scaling(scale: float):
    """VarianceScaling(scale, 'fan_in', 'truncated_normal')."""

    def init(shape, generator: Optional[torch.Generator] = None, device=None,
             dtype=None):
        std = math.sqrt(scale / fan_in(shape)) / _TRUNC_STD
        w = torch.empty(shape, device=device, dtype=dtype)
        return nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                                     generator=generator)

    return init


def he_normal(scale: float = 2.0):
    """He normal with a tunable ``scale`` (2.0 is He's); the initializer
    draws from the ``torch.Generator`` passed to it."""
    return variance_scaling(scale)


def lecun_normal():
    """flax's ``lecun_normal``: VarianceScaling(1, 'fan_in', truncated)."""
    return variance_scaling(1.0)
