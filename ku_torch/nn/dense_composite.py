"""Dense + batch-normalization composite layer (port of
``ku/nn/dense_composite.py``).

:class:`BatchNorm` is flax's ``nn.BatchNorm`` over the last axis, written
out because ``torch.nn.BatchNorm1d`` computes another running variance:

- training (``deterministic=False``) normalizes by the batch's statistics,
  taken over every axis but the last in at least float32, the variance the
  fast way, ``max(E[x²] − E[x]², 0)``: the *biased* variance, which is also
  what the running variance averages (torch's layers average the unbiased
  one);
- the running statistics move as ``r ← momentum·r + (1 − momentum)·batch``
  with flax's momentum (0.99 keeps 99 % of the old value; torch's layers
  write the same as momentum 0.01);
- inference reads the running statistics; ``y = (x − mean) · rsqrt(var +
  ε) · scale + bias``.

Parameters keep flax's names: ``scale`` and ``bias``, and the buffers
``mean`` and ``var`` (``ku``'s ``batch_stats``). The composite's children
are flax's auto-names ``Dense_0`` and ``BatchNorm_0``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ku_torch.nn.common import Activation, resolve_activation
from ku_torch.nn.transformer import Dense


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis (see module docstring)."""

    def __init__(self, features: int, momentum: float = 0.99, epsilon: float = 1e-5,
                 *, device="cuda", dtype=None):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        stats_dtype = torch.promote_types(dtype or torch.float32, torch.float32)
        self.scale = nn.Parameter(torch.ones(features, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(features, device=device, dtype=dtype))
        self.register_buffer("mean", torch.zeros(features, device=device, dtype=stats_dtype))
        self.register_buffer("var", torch.ones(features, device=device, dtype=stats_dtype))

    def forward(self, x, deterministic: bool = True):
        if deterministic:
            mean, var = self.mean, self.var
        else:
            xs = x.to(torch.promote_types(x.dtype, torch.float32))
            axes = tuple(range(x.dim() - 1))
            mean = xs.mean(dim=axes)
            var = ((xs * xs).mean(dim=axes) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean.detach())
                self.var.mul_(self.momentum).add_((1.0 - self.momentum) * var.detach())
        y = (x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias
        return y.to(torch.promote_types(x.dtype, self.scale.dtype))


class DenseBatchNormalization(nn.Module):
    """Dense, optional BN, optional activation, optional dropout (``ku``'s
    layer: BN on by default, momentum 0.99, ε 1e-3). Dropout draws from
    torch's global generator when not ``deterministic``."""

    def __init__(self, in_features: int, features: int, activation: Activation = None,
                 dropout_rate: Optional[float] = None, apply_bn: bool = True,
                 momentum: float = 0.99, epsilon: float = 1e-3, *, device="cuda",
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = resolve_activation(activation)
        self.dropout_rate = dropout_rate
        self.Dense_0 = Dense(in_features, features, device=device, dtype=dtype,
                             generator=generator)
        self.BatchNorm_0 = (BatchNorm(features, momentum, epsilon, device=device, dtype=dtype)
                            if apply_bn else None)

    def forward(self, x, deterministic: bool = True):
        x = self.Dense_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x, deterministic=deterministic)
        x = self.activation(x)
        if self.dropout_rate:
            x = F.dropout(x, self.dropout_rate, training=not deterministic)
        return x
