"""NobodyConvNet2D, the conf-driven 2-D conv backbone (port of
``ku/applications_ext/nobody_convnet2d.py``), channels-last.

Call path: a stride-2 separable stem, ``Block1`` (downsample), three
``Block2`` (residual), then ``Module5``'s 3×3 projection. ``Block3`` and
``Module6`` are on no call path, as in ``ku``; they are ported all the same.

Attribute names are flax's auto-names (``SepConvBNAct_0``, ``Block1_0``,
``Block2_0``…, ``Module5_0``; inside them ``Module1_0``, ``ConvBNAct_0``,
``BatchNorm_0``…), so ``ku``'s variables load strictly through
``ku_torch.utility.load_variables``. ``ku``'s quirks are kept as they are:
``Module2``'s second conv has ``max(1, int(nc / 2 * 2))`` = nc filters,
``Module3``'s 1×1 convs have no BN and no activation, and ``Module6``
upsamples nearest-neighbour by repetition.

Every constructor takes its input's channel count, which flax would infer;
:meth:`NobodyConvNet2D.from_conf` reads it from the input shape.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ku_torch.applications_ext._modules import (
    ConvBNAct,
    DepthwiseBNAct,
    SepConvBNAct,
    global_avg_pool_keepdims,
)

_R = 2  # rank


class Module1(nn.Module):
    """SepConv(nc) → Conv(2nc, stride 2)."""

    def __init__(self, in_channels: int, nc: int, rate: int = 1, bn_momentum: float = 0.99,
                 **kw):
        super().__init__()
        self.SepConvBNAct_0 = SepConvBNAct(_R, in_channels, nc, dilation=rate,
                                           bn_momentum=bn_momentum, **kw)
        self.ConvBNAct_0 = ConvBNAct(_R, nc, int(nc * 2), strides=2,
                                     bn_momentum=bn_momentum, **kw)

    def forward(self, x, deterministic: bool = True):
        return self.ConvBNAct_0(self.SepConvBNAct_0(x, deterministic), deterministic)


class Module2(nn.Module):
    """Conv(2nc) → Conv(nc) → depthwise conv."""

    def __init__(self, in_channels: int, nc: int, rate: int = 1, bn_momentum: float = 0.99,
                 **kw):
        super().__init__()
        mid = max(1, int(nc / 2 * 2))
        self.ConvBNAct_0 = ConvBNAct(_R, in_channels, int(nc * 2), dilation=rate,
                                     bn_momentum=bn_momentum, **kw)
        self.ConvBNAct_1 = ConvBNAct(_R, int(nc * 2), mid, bn_momentum=bn_momentum, **kw)
        self.DepthwiseBNAct_0 = DepthwiseBNAct(_R, mid, dilation=rate,
                                               bn_momentum=bn_momentum, **kw)

    def forward(self, x, deterministic: bool = True):
        x = self.ConvBNAct_0(x, deterministic)
        x = self.ConvBNAct_1(x, deterministic)
        return self.DepthwiseBNAct_0(x, deterministic)


class Module3(nn.Module):
    """Squeeze-excite: global average pool → 1×1(nc/4) → 1×1(nc), plain
    convs. ``bn_momentum`` is taken and unused, as in ``ku``."""

    def __init__(self, in_channels: int, nc: int, bn_momentum: float = 0.99, **kw):
        super().__init__()
        squeeze = max(1, int(nc / 4))
        self.ConvBNAct_0 = ConvBNAct(_R, in_channels, squeeze, kernel_size=1, use_bn=False,
                                     use_act=False, **kw)
        self.ConvBNAct_1 = ConvBNAct(_R, squeeze, nc, kernel_size=1, use_bn=False,
                                     use_act=False, **kw)

    def forward(self, x, deterministic: bool = True):
        x = global_avg_pool_keepdims(x, _R)
        return self.ConvBNAct_1(self.ConvBNAct_0(x, deterministic), deterministic)


class Module4(nn.Module):
    """The product of two branches, then a conv."""

    def __init__(self, in_channels: int, nc: int, rate: int = 1, bn_momentum: float = 0.99,
                 **kw):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(_R, in_channels, max(1, int(nc)), dilation=rate,
                                     bn_momentum=bn_momentum, **kw)

    def forward(self, inputs, deterministic: bool = True):
        a, b = inputs
        return self.ConvBNAct_0(a * b, deterministic)


class Module5(nn.Module):
    """A plain 3×3 projection conv, no BN, no activation."""

    def __init__(self, in_channels: int, nc: int, **kw):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(_R, in_channels, nc, use_bn=False, use_act=False, **kw)

    def forward(self, x, deterministic: bool = True):
        return self.ConvBNAct_0(x, deterministic)


class Module6(nn.Module):
    """2× nearest-neighbour upsampling (each pixel repeated) → conv → BN →
    ReLU."""

    def __init__(self, in_channels: int, nc: int, bn_momentum: float = 0.99, **kw):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(_R, in_channels, nc, bn_momentum=bn_momentum, **kw)

    def forward(self, x, deterministic: bool = True):
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
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
    """Downsample block: nc → 2nc channels at half the size."""

    def __init__(self, in_channels: int, nc: int, rate: int = 1, bn_momentum: float = 0.99,
                 **kw):
        super().__init__()
        nc2 = int(nc * 2)
        self.Module1_0 = Module1(in_channels, nc, rate, bn_momentum, **kw)
        self.Module2_0 = Module2(nc2, nc2, rate, bn_momentum, **kw)
        self.Module3_0 = Module3(nc2, nc2, bn_momentum, **kw)
        self.Module4_0 = Module4(nc2, nc2, rate, bn_momentum, **kw)

    def forward(self, x, deterministic: bool = True):
        x2 = self.Module1_0(x, deterministic)
        x3 = self.Module2_0(x2, deterministic)
        x4 = self.Module3_0(x2, deterministic)
        return self.Module4_0([x3, x4], deterministic)


class Block2(nn.Module):
    """Residual block: the input added to Module4's output."""

    def __init__(self, in_channels: int, nc: int, rate: int = 1, bn_momentum: float = 0.99,
                 **kw):
        super().__init__()
        self.Module2_0 = Module2(in_channels, nc, rate, bn_momentum, **kw)
        self.Module3_0 = Module3(nc, nc, bn_momentum, **kw)
        self.Module4_0 = Module4(nc, nc, rate, bn_momentum, **kw)
        self.Module7_0 = Module7(nc, nc, rate, bn_momentum, **kw)

    def forward(self, x, deterministic: bool = True):
        x2 = self.Module2_0(x, deterministic)
        x3 = self.Module3_0(x2, deterministic)
        x4 = self.Module4_0([x2, x3], deterministic)
        return self.Module7_0([x, x4], deterministic)


class Block3(nn.Module):
    """Upsampling residual block."""

    def __init__(self, in_channels: int, nc: int, rate: int = 1, bn_momentum: float = 0.99,
                 **kw):
        super().__init__()
        self.Module6_0 = Module6(in_channels, nc, bn_momentum, **kw)
        self.Module2_0 = Module2(nc, nc, rate, bn_momentum, **kw)
        self.Module3_0 = Module3(nc, nc, bn_momentum, **kw)
        self.Module4_0 = Module4(nc, nc, rate, bn_momentum, **kw)
        self.Module7_0 = Module7(nc, nc, rate, bn_momentum, **kw)

    def forward(self, x, deterministic: bool = True):
        x2 = self.Module6_0(x, deterministic)
        x3 = self.Module2_0(x2, deterministic)
        x4 = self.Module3_0(x2, deterministic)
        x5 = self.Module4_0([x3, x4], deterministic)
        return self.Module7_0([x2, x5], deterministic)


class NobodyConvNet2D(nn.Module):
    """The backbone: (B, H, W, C) → (B, ⌈⌈H/2⌉/2⌉, ⌈⌈W/2⌉/2⌉,
    sp_feature_dim). Build it from ``ku``'s conf with
    ``NobodyConvNet2D.from_conf(conf, input_shape)``."""

    def __init__(self, in_channels: int, sp_feature_dim: int, conv_rate_multiplier: int = 1,
                 bn_momentum: float = 0.99, *, device="cuda", dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        rate = conv_rate_multiplier
        nc = int(in_channels * 4)
        self.SepConvBNAct_0 = SepConvBNAct(_R, in_channels, nc, strides=2, dilation=rate,
                                           bn_momentum=bn_momentum, **kw)
        self.Block1_0 = Block1(nc, nc, rate, bn_momentum, **kw)
        nc = int(nc * 2)
        self.Block2_0 = Block2(nc, nc, rate, bn_momentum, **kw)
        self.Block2_1 = Block2(nc, nc, rate, bn_momentum, **kw)
        self.Block2_2 = Block2(nc, nc, rate, bn_momentum, **kw)
        self.Module5_0 = Module5(nc, sp_feature_dim, **kw)

    @classmethod
    def from_conf(cls, conf, input_shape: Tuple[int, ...], **kw):
        """``ku``'s conf (``nn_arch.sp_feature_dim``, ``conv_rate_multiplier``;
        ``hps.bn_momentum``); the channels are ``input_shape[-1]``."""
        nn_arch = conf["nn_arch"]
        hps = conf.get("hps", {})
        return cls(in_channels=int(input_shape[-1]),
                   sp_feature_dim=int(nn_arch["sp_feature_dim"]),
                   conv_rate_multiplier=int(nn_arch.get("conv_rate_multiplier", 1)),
                   bn_momentum=float(hps.get("bn_momentum", 0.99)), **kw)

    def forward(self, x, deterministic: bool = True):
        x = self.SepConvBNAct_0(x, deterministic)
        x = self.Block1_0(x, deterministic)
        x = self.Block2_0(x, deterministic)
        x = self.Block2_1(x, deterministic)
        x = self.Block2_2(x, deterministic)
        return self.Module5_0(x, deterministic)
