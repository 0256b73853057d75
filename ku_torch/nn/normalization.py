"""AdaIN and pixel norm (port of ``ku/nn/normalization.py``), channels-last.

σ is the population standard deviation (``jnp.std``'s ddof 0, so
``correction=0`` here, not torch's default), and ε is added to σ, not
under the root.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def _reduce_axes(ndim: int, channel_axis: int) -> Sequence[int]:
    if channel_axis < 0:
        channel_axis = ndim + channel_axis
    return tuple(i for i in range(1, ndim) if i != channel_axis)


def _mean_std(x, axes):
    return (x.mean(dim=axes, keepdim=True),
            torch.std(x, dim=axes, keepdim=True, correction=0))


class AdaptiveIN(nn.Module):
    """AdaIN between a content and a style tensor:
    ``σ_s·(c − μ_c)/(σ_c + ε) + μ_s``, statistics over the non-batch,
    non-channel axes."""

    def __init__(self, axis: int = -1, epsilon: float = 1e-7):
        super().__init__()
        self.axis, self.epsilon = axis, epsilon

    def forward(self, inputs):
        c, s = inputs
        axes = _reduce_axes(c.dim(), self.axis)
        c_mean, c_std = _mean_std(c, axes)
        s_mean, s_std = _mean_std(s, axes)
        return s_std * ((c - c_mean) / (c_std + self.epsilon)) + s_mean


class AdaptiveINWithStyle(nn.Module):
    """StyleGAN's AdaIN driven by a style vector: ``inputs = [content (N, H,
    W, C), style (N, 2C)]``, the style packing (scale, bias) per channel;
    the output is ``(scale + 1)·(c − μ)/(σ + ε) + bias``."""

    def __init__(self, axis: int = -1, epsilon: float = 1e-7):
        super().__init__()
        self.axis, self.epsilon = axis, epsilon

    def forward(self, inputs):
        c, s = inputs
        if s.dim() != 2 or s.shape[-1] != 2 * c.shape[-1]:
            raise ValueError(f"style {tuple(s.shape)} does not fit content "
                             f"{tuple(c.shape)}: want (N, 2C)")
        axes = _reduce_axes(c.dim(), self.axis)
        c_mean, c_std = _mean_std(c, axes)
        s = s.reshape((-1, 2) + (1,) * (c.dim() - 2) + (c.shape[-1],))
        return (s[:, 0] + 1.0) * ((c - c_mean) / (c_std + self.epsilon)) + s[:, 1]


def pixel_norm(x, epsilon: float = 1e-8):
    """``x · rsqrt(mean(x², -1) + ε)``."""
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + epsilon)


class PixelNorm(nn.Module):
    """Pixelwise feature normalization over the last axis."""

    def __init__(self, epsilon: float = 1e-8):
        super().__init__()
        self.epsilon = epsilon

    def forward(self, x):
        return pixel_norm(x, self.epsilon)
