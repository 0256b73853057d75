"""Shared building blocks of the NobodyConvNet backbones (port of
``ku/applications_ext/_modules.py``), channels-last, ranks 2 and 3.

flax infers a layer's input channels from its first call; the port's
constructors take them (``in_channels``), and the backbones' ``from_conf``
works every width out from the input shape. Parameters keep flax's names
and layouts: the conv kernel (*k, in, out) as ``kernel`` (no bias), the
separable conv's ``depthwise_kernel`` (*k, in, 1) and ``pointwise_kernel``
(1, …, 1, in, filters), each drawn from a normal at stddev 0.05 cut at ±2σ
(matched in distribution only), and flax's ``BatchNorm`` as
``BatchNorm_0`` (:class:`ku_torch.nn.BatchNorm`: ε 1e-5, flax's momentum,
the biased batch variance, ``mean`` / ``var`` buffers). Weight decay is the
optimizer's, as in ``ku``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ku_torch.nn.common import normalize_tuple, truncated_normal_init
from ku_torch.nn.convolution import _depthwise_nd, conv_nd
from ku_torch.nn.dense_composite import BatchNorm

_INIT = truncated_normal_init(0.05)


def _kernel(shape, device, dtype, generator):
    return nn.Parameter(_INIT(shape, generator, device, dtype))


class ConvBNAct(nn.Module):
    """Conv → BN → ReLU, the BN and the ReLU optional."""

    def __init__(self, rank: int, in_channels: int, filters: int, kernel_size=3,
                 strides=1, padding: str = "same", dilation=1, use_act: bool = True,
                 use_bn: bool = True, bn_momentum: float = 0.99, *, device="cuda",
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rank, self.padding, self.use_act = rank, padding, use_act
        self.strides = normalize_tuple(strides, rank)
        self.dilation = normalize_tuple(dilation, rank)
        self.kernel = _kernel(normalize_tuple(kernel_size, rank) + (in_channels, filters),
                              device, dtype, generator)
        self.BatchNorm_0 = (BatchNorm(filters, bn_momentum, device=device, dtype=dtype)
                            if use_bn else None)

    def forward(self, x, deterministic: bool = True):
        x = conv_nd(x, self.kernel, self.strides, self.padding, self.rank, self.dilation)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x, deterministic)
        return torch.relu(x) if self.use_act else x


class DepthwiseBNAct(nn.Module):
    """Depthwise conv (stride 1; output channel c·mult + m) → BN → ReLU."""

    def __init__(self, rank: int, in_channels: int, kernel_size=3, depth_multiplier: int = 1,
                 padding: str = "same", dilation=1, bn_momentum: float = 0.99, *,
                 device="cuda", dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rank, self.padding = rank, padding
        self.dilation = normalize_tuple(dilation, rank)
        self.kernel = _kernel(normalize_tuple(kernel_size, rank)
                              + (in_channels, depth_multiplier), device, dtype, generator)
        self.BatchNorm_0 = BatchNorm(in_channels * depth_multiplier, bn_momentum,
                                     device=device, dtype=dtype)

    def forward(self, x, deterministic: bool = True):
        x = _depthwise_nd(x, self.kernel, (1,) * self.rank, self.padding, self.rank,
                          self.dilation)
        return torch.relu(self.BatchNorm_0(x, deterministic))


class SepConvBNAct(nn.Module):
    """Separable conv (depthwise at the stride, then a 1×…×1 pointwise
    conv) → BN → ReLU, the BN and the ReLU optional."""

    def __init__(self, rank: int, in_channels: int, filters: int, kernel_size=3,
                 strides=1, padding: str = "same", dilation=1, bn_momentum: float = 0.99,
                 use_bn: bool = True, use_act: bool = True, *, device="cuda", dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rank, self.padding, self.use_act = rank, padding, use_act
        self.strides = normalize_tuple(strides, rank)
        self.dilation = normalize_tuple(dilation, rank)
        self.depthwise_kernel = _kernel(normalize_tuple(kernel_size, rank) + (in_channels, 1),
                                        device, dtype, generator)
        self.pointwise_kernel = _kernel((1,) * rank + (in_channels, filters), device, dtype,
                                        generator)
        self.BatchNorm_0 = (BatchNorm(filters, bn_momentum, device=device, dtype=dtype)
                            if use_bn else None)

    def forward(self, x, deterministic: bool = True):
        x = _depthwise_nd(x, self.depthwise_kernel, self.strides, self.padding, self.rank,
                          self.dilation)
        x = conv_nd(x, self.pointwise_kernel, (1,) * self.rank, "valid", self.rank)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x, deterministic)
        return torch.relu(x) if self.use_act else x


def global_avg_pool_keepdims(x, rank: int):
    return x.mean(dim=tuple(range(1, rank + 1)), keepdim=True)
