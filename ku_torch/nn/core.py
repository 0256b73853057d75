"""Equalized-learning-rate dense layer (port of ``ku/nn/core.py``).

The kernel is drawn at TruncatedNormal(1/lrmul) and scaled at run time by
``gain / sqrt(fan_in) * lrmul``, where ``fan_in`` is the product of all
the input's non-batch dims at call time (``ku``'s reading of the
reference). The kernel is ``ku``'s (in, out), applied as
``x @ kernel + bias``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ku_torch.nn.common import (
    Activation,
    equalized_coeff,
    resolve_activation,
    truncated_normal_init,
)


class EqualizedLRDense(nn.Module):
    """Equalized learning-rate dense layer. ``dtype`` is the compute dtype
    (the input's when None); parameters stay float32."""

    def __init__(self, in_features: int, features: int,
                 activation: Activation = None, use_bias: bool = True,
                 gain: float = math.sqrt(2.0), lrmul: float = 1.0,
                 dtype: Optional[torch.dtype] = None, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = resolve_activation(activation)
        self.gain, self.lrmul, self.dtype = gain, lrmul, dtype
        self.kernel = nn.Parameter(truncated_normal_init(1.0 / lrmul)(
            (in_features, features), generator, device, torch.float32))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, x):
        coeff = equalized_coeff(self.gain, self.lrmul, math.prod(x.shape[1:]))
        dtype = self.dtype or x.dtype
        y = x.to(dtype) @ (self.kernel * coeff).to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return self.activation(y)
