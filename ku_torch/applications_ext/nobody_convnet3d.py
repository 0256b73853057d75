"""NobodyConvNet3D, the conf-driven 3-D conv backbone (port of
``ku/applications_ext/nobody_convnet3d.py``), channels-last.

Not the 2-D file at rank 3: the stem has stride 1 and ``in_channels·10``
filters; each ``Block1`` grows the channels to ``int(nc·1.5)``; ``Module2``
is separable conv → stride-2 VALID conv (nc/2 filters) → separable conv;
``Module3`` squeezes to nc/2 and takes no momentum; ``Module4`` multiplies
then applies a separable conv; ``Block1`` adds Module2's output to
Module4's, ``Block2`` adds Module3's (a 1×1×1 map, broadcast). The call
path is the stem, ``depth`` ``Block1``s, then ``Module5``. ``Block2``,
``Block3`` and ``Module6`` are on no call path, as in ``ku``.

The depthwise convs are grouped 3-D convolutions (cuDNN on the card).
Names are flax's auto-names, as in :mod:`.nobody_convnet2d`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ku_torch.applications_ext._modules import (
    ConvBNAct,
    SepConvBNAct,
    global_avg_pool_keepdims,
)

_R = 3


class Module1(nn.Module):
    """SepConv3D(nc) → Conv3D(1.5nc, stride 2, SAME)."""

    def __init__(self, in_channels: int, nc: int, rate: int = 1, bn_momentum: float = 0.99,
                 **kw):
        super().__init__()
        self.SepConvBNAct_0 = SepConvBNAct(_R, in_channels, nc, dilation=rate,
                                           bn_momentum=bn_momentum, **kw)
        self.ConvBNAct_0 = ConvBNAct(_R, nc, int(nc * 1.5), strides=2, padding="same",
                                     bn_momentum=bn_momentum, **kw)

    def forward(self, x, deterministic: bool = True):
        return self.ConvBNAct_0(self.SepConvBNAct_0(x, deterministic), deterministic)


class Module2(nn.Module):
    """SepConv3D(nc) → Conv3D(nc/2, stride 2, VALID) → SepConv3D(nc)."""

    def __init__(self, in_channels: int, nc: int, rate: int = 1, bn_momentum: float = 0.99,
                 **kw):
        super().__init__()
        half = max(1, int(nc / 2))
        self.SepConvBNAct_0 = SepConvBNAct(_R, in_channels, nc, dilation=rate,
                                           bn_momentum=bn_momentum, **kw)
        self.ConvBNAct_0 = ConvBNAct(_R, nc, half, strides=2, padding="valid",
                                     bn_momentum=bn_momentum, **kw)
        self.SepConvBNAct_1 = SepConvBNAct(_R, half, nc, dilation=rate,
                                           bn_momentum=bn_momentum, **kw)

    def forward(self, x, deterministic: bool = True):
        x = self.SepConvBNAct_0(x, deterministic)
        x = self.ConvBNAct_0(x, deterministic)
        return self.SepConvBNAct_1(x, deterministic)


class Module3(nn.Module):
    """Squeeze-excite: global average pool → 1×1×1(nc/2) → 1×1×1(nc),
    plain convs."""

    def __init__(self, in_channels: int, nc: int, **kw):
        super().__init__()
        squeeze = max(1, int(nc / 2))
        self.ConvBNAct_0 = ConvBNAct(_R, in_channels, squeeze, kernel_size=1, use_bn=False,
                                     use_act=False, **kw)
        self.ConvBNAct_1 = ConvBNAct(_R, squeeze, nc, kernel_size=1, use_bn=False,
                                     use_act=False, **kw)

    def forward(self, x, deterministic: bool = True):
        x = global_avg_pool_keepdims(x, _R)
        return self.ConvBNAct_1(self.ConvBNAct_0(x, deterministic), deterministic)


class Module4(nn.Module):
    """The product of two branches, then a separable conv."""

    def __init__(self, in_channels: int, nc: int, rate: int = 1, bn_momentum: float = 0.99,
                 **kw):
        super().__init__()
        self.SepConvBNAct_0 = SepConvBNAct(_R, in_channels, nc, dilation=rate,
                                           bn_momentum=bn_momentum, **kw)

    def forward(self, inputs, deterministic: bool = True):
        a, b = inputs
        return self.SepConvBNAct_0(a * b, deterministic)


class Module5(nn.Module):
    """The final 3×3×3 projection conv, no BN, no activation."""

    def __init__(self, in_channels: int, nc: int, **kw):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(_R, in_channels, nc, use_bn=False, use_act=False, **kw)

    def forward(self, x, deterministic: bool = True):
        return self.ConvBNAct_0(x, deterministic)


class Module6(nn.Module):
    """2× nearest-neighbour upsampling on each spatial axis → conv."""

    def __init__(self, in_channels: int, nc: int, bn_momentum: float = 0.99, **kw):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(_R, in_channels, nc, bn_momentum=bn_momentum, **kw)

    def forward(self, x, deterministic: bool = True):
        for axis in (1, 2, 3):
            x = x.repeat_interleave(2, dim=axis)
        return self.ConvBNAct_0(x, deterministic)


class Module7(nn.Module):
    """The sum of two branches, then a conv."""

    def __init__(self, in_channels: int, nc: int, rate: int = 1, bn_momentum: float = 0.99,
                 **kw):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(_R, in_channels, nc, dilation=rate,
                                     bn_momentum=bn_momentum, **kw)

    def forward(self, inputs, deterministic: bool = True):
        a, b = inputs
        return self.ConvBNAct_0(a + b, deterministic)


class Block1(nn.Module):
    """Downsample block with a residual: nc → int(1.5nc) channels."""

    def __init__(self, in_channels: int, nc: int, rate: int = 1, bn_momentum: float = 0.99,
                 **kw):
        super().__init__()
        nc15 = int(nc * 1.5)
        self.Module1_0 = Module1(in_channels, nc, rate, bn_momentum, **kw)
        self.Module2_0 = Module2(nc15, nc15, rate, bn_momentum, **kw)
        self.Module3_0 = Module3(nc15, nc15, **kw)
        self.Module4_0 = Module4(nc15, nc15, rate, bn_momentum, **kw)
        self.Module7_0 = Module7(nc15, nc15, rate, bn_momentum, **kw)

    def forward(self, x, deterministic: bool = True):
        x2 = self.Module1_0(x, deterministic)
        x3 = self.Module2_0(x2, deterministic)
        x4 = self.Module3_0(x2, deterministic)
        x5 = self.Module4_0([x3, x4], deterministic)
        return self.Module7_0([x3, x5], deterministic)


class Block2(nn.Module):
    """Residual block: Module3's output added to Module4's."""

    def __init__(self, in_channels: int, nc: int, rate: int = 1, bn_momentum: float = 0.99,
                 **kw):
        super().__init__()
        self.Module2_0 = Module2(in_channels, nc, rate, bn_momentum, **kw)
        self.Module3_0 = Module3(nc, nc, **kw)
        self.Module4_0 = Module4(nc, nc, rate, bn_momentum, **kw)
        self.Module7_0 = Module7(nc, nc, rate, bn_momentum, **kw)

    def forward(self, x, deterministic: bool = True):
        x2 = self.Module2_0(x, deterministic)
        x3 = self.Module3_0(x2, deterministic)
        x4 = self.Module4_0([x2, x3], deterministic)
        return self.Module7_0([x3, x4], deterministic)


class Block3(nn.Module):
    """Upsampling block."""

    def __init__(self, in_channels: int, nc: int, rate: int = 1, bn_momentum: float = 0.99,
                 **kw):
        super().__init__()
        self.Module6_0 = Module6(in_channels, nc, bn_momentum, **kw)
        self.Module2_0 = Module2(nc, nc, rate, bn_momentum, **kw)
        self.Module3_0 = Module3(nc, nc, **kw)
        self.Module4_0 = Module4(nc, nc, rate, bn_momentum, **kw)
        self.Module7_0 = Module7(nc, nc, rate, bn_momentum, **kw)

    def forward(self, x, deterministic: bool = True):
        x2 = self.Module6_0(x, deterministic)
        x3 = self.Module2_0(x2, deterministic)
        x4 = self.Module3_0(x2, deterministic)
        x5 = self.Module4_0([x3, x4], deterministic)
        return self.Module7_0([x2, x5], deterministic)


class NobodyConvNet3D(nn.Module):
    """The 3-D backbone: (B, D, H, W, C) → (…, sp_feature_dim) after
    ``depth`` ``Block1`` stages (each Module2's stride-2 VALID conv shrinks
    the volume fast, so the depth is an argument)."""

    def __init__(self, in_channels: int, sp_feature_dim: int, conv_rate_multiplier: int = 1,
                 bn_momentum: float = 0.99, depth: int = 2, *, device="cuda", dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        rate = conv_rate_multiplier
        nc = int(in_channels * 10)
        self.depth = depth
        self.SepConvBNAct_0 = SepConvBNAct(_R, in_channels, nc, dilation=rate,
                                           bn_momentum=bn_momentum, **kw)
        for i in range(depth):
            self.add_module(f"Block1_{i}", Block1(nc, nc, rate, bn_momentum, **kw))
            nc = int(nc * 1.5)
        self.Module5_0 = Module5(nc, sp_feature_dim, **kw)

    @classmethod
    def from_conf(cls, conf, input_shape: Tuple[int, ...], depth: int = 2, **kw):
        nn_arch = conf["nn_arch"]
        hps = conf.get("hps", {})
        return cls(in_channels=int(input_shape[-1]),
                   sp_feature_dim=int(nn_arch["sp_feature_dim"]),
                   conv_rate_multiplier=int(nn_arch.get("conv_rate_multiplier", 1)),
                   bn_momentum=float(hps.get("bn_momentum", 0.99)), depth=depth, **kw)

    def forward(self, x, deterministic: bool = True):
        x = self.SepConvBNAct_0(x, deterministic)
        for i in range(self.depth):
            x = getattr(self, f"Block1_{i}")(x, deterministic)
        return self.Module5_0(x, deterministic)
