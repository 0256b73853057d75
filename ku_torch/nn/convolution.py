"""Convolution layers (port of ``ku/nn/convolution.py``), channels-last.

The layers take and return channels-last tensors (N, *spatial, C) and keep
``ku``'s parameter layouts: conv kernels (*spatial, in, out), depthwise
kernels Keras' (*spatial, C, multiplier). Each torch op sees a permuted
view, (N, C, *spatial) over the channels-last storage, and a kernel
transposed to (out, in, *spatial) at the call, so cuDNN runs the
channels-last memory format and the stored parameters never change.

Where the two packages can part (each pinned in
tests/test_torch_stylegan_layers.py):

- SAME padding is XLA's: the total ``max((⌈n/s⌉−1)·s + k_eff − n, 0)``,
  ``total // 2`` before and the rest after, so an even kernel at stride 2
  pads (1, 1) where torch's ``padding="same"`` refuses stride > 1.
- ``FusedEqualizedLRConv2DTranspose`` is ``lax.conv_transpose`` with
  ``transpose_kernel=False``: it correlates the stride-dilated input with
  the kernel as stored, padded by ``_conv_transpose_padding`` ((2, 2) for
  the fused 4×4 kernel at stride 2). ``F.conv_transpose2d`` is conv2d's
  gradient, which flips the kernel, so it gets the kernel flipped back and
  the padding ``k − 1 − pad``.
- The runtime coefficient's fan-in is the product of all the input's
  non-batch dims at call time, so it depends on the resolution: it is
  computed in ``forward``.
- The blur kernel is stored flipped, in Keras' depthwise layout; its bias is
  zero and takes no gradient.

``ku``'s ``lane_packed`` layers (a TPU space-to-depth layout with the same
parameters) compute the unpacked function here: the models accept
``lane_packing``; the packed functions themselves are
:mod:`ku_torch.nn.packed`, for parity.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
from torch import nn
from torch.nn import functional as F

from ku_torch.initializers_ext.initializers import lecun_normal
from ku_torch.nn.common import (
    Activation,
    equalized_coeff,
    normalize_tuple,
    resolve_activation,
    truncated_normal_init,
)

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def to_channels_first(x):
    """(N, *spatial, C) → an (N, C, *spatial) view of the same storage."""
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def to_channels_last(x):
    """Inverse of :func:`to_channels_first`, again a view."""
    return x.permute(0, *range(2, x.dim()), 1)


def _kernel_oi(kernel):
    """(*spatial, in, out) → (out, in, *spatial)."""
    rank = kernel.dim() - 2
    return kernel.permute(rank + 1, rank, *range(rank))


def same_padding(n: int, k: int, s: int, d: int = 1):
    """XLA's SAME padding of one spatial dim: (before, after)."""
    k_eff = (k - 1) * d + 1
    total = max((-(-n // s) - 1) * s + k_eff - n, 0)
    return total // 2, total - total // 2


def _pads(padding, spatial, ksize, strides, dilation):
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * len(spatial)
        if padding.upper() != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        return [same_padding(n, k, s, d)
                for n, k, s, d in zip(spatial, ksize, strides, dilation)]
    return [tuple(p) for p in padding]


def conv_nd(x, kernel, strides, padding, rank, dilation=None, groups=1):
    """Channels-last N-D convolution, ``lax.conv_general_dilated`` with
    dimension numbers (N, *spatial, C) / (*spatial, I, O): ``padding`` is
    "SAME", "VALID" or (before, after) pairs."""
    strides = normalize_tuple(strides, rank)
    dilation = normalize_tuple(dilation or 1, rank)
    pads = _pads(padding, x.shape[1:-1], kernel.shape[:rank], strides, dilation)
    if any(lo != hi for lo, hi in pads):
        x = F.pad(x, _pad_arg(pads))
        pads = [(0, 0)] * rank
    y = _CONV[rank](to_channels_first(x), _kernel_oi(kernel), stride=strides,
                    padding=tuple(lo for lo, _ in pads), dilation=dilation,
                    groups=groups)
    return to_channels_last(y)


def _pad_arg(pads):
    """F.pad's argument for a channels-last tensor: the channel dim first
    (unpadded), then the spatial dims from the last."""
    out = [0, 0]
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def _fuse_kernel(kernel, rank: int, average: bool):
    """Pad the spatial dims by 1 and combine the 2^rank shifted copies:
    their mean for the fused conv, their sum for the fused transpose."""
    k = F.pad(kernel, [0, 0, 0, 0] + [1, 1] * rank)
    shifts = [k]
    for axis in range(rank):
        shifts = [s.narrow(axis, start, s.shape[axis] - 1)
                  for s in shifts for start in (1, 0)]
    out = shifts[0]
    for s in shifts[1:]:
        out = out + s
    if average:
        out = out / float(len(shifts))
    return out


class _EqualizedLRConvBase(nn.Module):
    """Shared body of the (fused) equalized-LR convs. ``dtype`` is the
    compute dtype (the input's when None); parameters stay float32."""

    rank = 2
    fused = False

    def __init__(self, in_channels: int, filters: int,
                 kernel_size: Union[int, Sequence[int]],
                 strides: Union[int, Sequence[int]] = 1,
                 padding: Union[str, Sequence] = "valid",
                 dilation_rate: Union[int, Sequence[int]] = 1,
                 activation: Activation = None, use_bias: bool = True,
                 gain: float = math.sqrt(2.0), lrmul: float = 1.0,
                 dtype: Optional[torch.dtype] = None, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        rank = self.rank
        self.strides = normalize_tuple(strides, rank)
        self.dilation = normalize_tuple(dilation_rate, rank)
        self.padding = padding
        self.activation = resolve_activation(activation)
        self.gain, self.lrmul, self.dtype = gain, lrmul, dtype
        shape = normalize_tuple(kernel_size, rank) + (in_channels, filters)
        self.kernel = nn.Parameter(truncated_normal_init(1.0 / lrmul)(
            shape, generator, device, torch.float32))
        self.bias = (nn.Parameter(torch.zeros(filters, device=device))
                     if use_bias else None)

    def forward(self, x):
        coeff = equalized_coeff(self.gain, self.lrmul, math.prod(x.shape[1:]))
        scaled = self.kernel * coeff
        if self.fused:
            scaled = _fuse_kernel(scaled, self.rank, average=True)
        dtype = self.dtype or x.dtype
        y = conv_nd(x.to(dtype), scaled.to(dtype), self.strides, self.padding,
                    self.rank, self.dilation)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return self.activation(y)


class EqualizedLRConv1D(_EqualizedLRConvBase):
    """Equalized-LR 1-D conv."""

    rank = 1


class EqualizedLRConv2D(_EqualizedLRConvBase):
    """Equalized-LR 2-D conv."""

    rank = 2


class EqualizedLRConv3D(_EqualizedLRConvBase):
    """Equalized-LR 3-D conv."""

    rank = 3


class FusedEqualizedLRConv1D(_EqualizedLRConvBase):
    """Fused equalized-LR 1-D conv (the kernel box-smoothed first)."""

    rank, fused = 1, True


class FusedEqualizedLRConv2D(_EqualizedLRConvBase):
    """Fused equalized-LR 2-D conv: StyleGAN's blur + downscale conv at
    stride 2."""

    rank, fused = 2, True


class FusedEqualizedLRConv3D(_EqualizedLRConvBase):
    """Fused equalized-LR 3-D conv."""

    rank, fused = 3, True


def _conv_transpose_padding(k: int, s: int, padding: str):
    """``jax.lax``'s padding of the dilated input for SAME / VALID."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"unknown padding {padding!r}")
    return pad_a, pad_len - pad_a


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def conv_transpose_nd(x, kernel, strides, padding: str, rank: int):
    """``lax.conv_transpose(x, kernel, strides, padding)`` over channels-last
    x and a (*spatial, in, out) kernel, with ``transpose_kernel=False`` (flax's
    ``nn.ConvTranspose``): out[y] = Σ_k x_dilated_padded[y + k] · kernel[k],
    the kernel as stored (not flipped), the dilated input padded by
    ``_conv_transpose_padding`` ("SAME" or "VALID")."""
    ksize = kernel.shape[:rank]
    strides = normalize_tuple(strides, rank)
    pads = [_conv_transpose_padding(k, s, padding.upper()) for k, s in zip(ksize, strides)]
    # conv_transpose scatters x[i] · w[k'] to i·s + k' − p: with w the
    # kernel flipped, k' = K − 1 − k, that is out[y] above with p = K − 1 − pad.
    w = kernel.flip(tuple(range(rank))).permute(rank, rank + 1, *range(rank))
    torch_pads = [(k - 1 - lo, k - 1 - hi) for k, (lo, hi) in zip(ksize, pads)]
    if all(lo == hi and lo >= 0 for lo, hi in torch_pads):
        y = _CONV_T[rank](to_channels_first(x), w, stride=strides,
                          padding=tuple(lo for lo, _ in torch_pads))
        return to_channels_last(y)
    # An odd k + s − 2 pads one side more: crop the full output to it (or
    # pad it, where lax pads past the full output).
    y = to_channels_last(_CONV_T[rank](to_channels_first(x), w, stride=strides))
    return F.pad(y, _pad_arg([(-lo, -hi) for lo, hi in torch_pads]))


def conv_transpose2d(x, kernel, strides, padding: str):
    """:func:`conv_transpose_nd` at rank 2 (NHWC / HWIO)."""
    return conv_transpose_nd(x, kernel, strides, padding, 2)


class FusedEqualizedLRConv2DTranspose(nn.Module):
    """Fused equalized-LR transposed 2-D conv: the runtime-scaled kernel,
    padded by 1 per spatial side, its four shifts *summed*; with stride 2
    this is StyleGAN's fused 2× upsample + conv. The kernel is (kh, kw, in,
    out)."""

    def __init__(self, in_channels: int, filters: int,
                 kernel_size: Union[int, Sequence[int]],
                 strides: Union[int, Sequence[int]] = 1, padding: str = "valid",
                 activation: Activation = None, use_bias: bool = True,
                 gain: float = math.sqrt(2.0), lrmul: float = 1.0,
                 dtype: Optional[torch.dtype] = None, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.strides = normalize_tuple(strides, 2)
        self.padding = padding
        self.activation = resolve_activation(activation)
        self.gain, self.lrmul, self.dtype = gain, lrmul, dtype
        shape = normalize_tuple(kernel_size, 2) + (in_channels, filters)
        self.kernel = nn.Parameter(truncated_normal_init(1.0 / lrmul)(
            shape, generator, device, torch.float32))
        self.bias = (nn.Parameter(torch.zeros(filters, device=device))
                     if use_bias else None)

    def forward(self, x):
        coeff = equalized_coeff(self.gain, self.lrmul, math.prod(x.shape[1:]))
        fused = _fuse_kernel(self.kernel * coeff, 2, average=False)
        dtype = self.dtype or x.dtype
        y = conv_transpose2d(x.to(dtype), fused.to(dtype), self.strides, self.padding)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return self.activation(y)


def _depthwise_nd(x, kernel_keras, strides, padding, rank, dilation=None):
    """Grouped conv from a Keras-layout depthwise kernel (*spatial, C, mult):
    output channel c·mult + m."""
    spatial = tuple(kernel_keras.shape[:rank])
    in_ch, mult = kernel_keras.shape[rank], kernel_keras.shape[rank + 1]
    rhs = kernel_keras.reshape(spatial + (1, in_ch * mult))
    return conv_nd(x, rhs, strides, padding, rank, dilation, groups=in_ch)


def blur_kernel_init(blur_kernel, in_ch: int, depth_multiplier: int, device=None):
    """The normalized ``b ⊗ b`` blur, flipped, tiled to (k, k, C, mult)."""
    b = torch.tensor(blur_kernel, dtype=torch.float32, device=device)
    f = b[:, None] * b[None, :]
    f = (f / f.sum()).flip(0, 1)[:, :, None, None]
    return f.repeat(1, 1, in_ch, depth_multiplier)


class BlurDepthwiseConv2D(nn.Module):
    """StyleGAN's blur: a depthwise conv whose kernel starts as the
    normalized, flipped ``blur_kernel ⊗ blur_kernel`` tiled over channels.
    ``trainable=False`` stops its gradient; the bias is zero and never takes
    one."""

    def __init__(self, in_channels: int, blur_kernel: Sequence[int] = (1, 2, 1),
                 strides: Union[int, Sequence[int]] = 1, padding: str = "same",
                 depth_multiplier: int = 1, use_bias: bool = True,
                 trainable: bool = True, *, device="cuda"):
        super().__init__()
        self.strides = normalize_tuple(strides, 2)
        self.padding = padding
        self.trainable = trainable
        self.kernel = nn.Parameter(blur_kernel_init(blur_kernel, in_channels,
                                                    depth_multiplier, device))
        self.bias = (nn.Parameter(torch.zeros(in_channels * depth_multiplier,
                                              device=device))
                     if use_bias else None)

    def forward(self, x):
        kernel = self.kernel if self.trainable else self.kernel.detach()
        y = _depthwise_nd(x, kernel.to(x.dtype), self.strides, self.padding, 2)
        if self.bias is not None:
            y = y + self.bias.detach().to(x.dtype)
        return y


class DepthwiseConv3D(nn.Module):
    """3-D depthwise conv: one grouped conv, Keras' kernel layout
    (kd, kh, kw, C, mult), lecun-normal init."""

    def __init__(self, in_channels: int, kernel_size: Union[int, Sequence[int]],
                 strides: Union[int, Sequence[int]] = 1, padding: str = "valid",
                 depth_multiplier: int = 1,
                 dilation_rate: Union[int, Sequence[int]] = 1,
                 activation: Activation = None, use_bias: bool = True, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.strides = normalize_tuple(strides, 3)
        self.dilation = normalize_tuple(dilation_rate, 3)
        self.padding = padding
        self.activation = resolve_activation(activation)
        shape = normalize_tuple(kernel_size, 3) + (in_channels, depth_multiplier)
        self.kernel = nn.Parameter(lecun_normal()(shape, generator, device,
                                                  torch.float32))
        self.bias = (nn.Parameter(torch.zeros(in_channels * depth_multiplier,
                                              device=device))
                     if use_bias else None)

    def forward(self, x):
        y = _depthwise_nd(x, self.kernel.to(x.dtype), self.strides, self.padding,
                          3, self.dilation)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return self.activation(y)


class SeparableConv3D(nn.Module):
    """Separable 3-D conv: depthwise, then a 1×1×1 pointwise conv
    (``depthwise_kernel``, ``pointwise_kernel``, ``bias``)."""

    def __init__(self, in_channels: int, filters: int,
                 kernel_size: Union[int, Sequence[int]],
                 strides: Union[int, Sequence[int]] = 1, padding: str = "valid",
                 depth_multiplier: int = 1,
                 dilation_rate: Union[int, Sequence[int]] = 1,
                 activation: Activation = None, use_bias: bool = True, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.strides = normalize_tuple(strides, 3)
        self.dilation = normalize_tuple(dilation_rate, 3)
        self.padding = padding
        self.activation = resolve_activation(activation)
        init = lecun_normal()
        self.depthwise_kernel = nn.Parameter(init(
            normalize_tuple(kernel_size, 3) + (in_channels, depth_multiplier),
            generator, device, torch.float32))
        self.pointwise_kernel = nn.Parameter(init(
            (1, 1, 1, in_channels * depth_multiplier, filters), generator, device,
            torch.float32))
        self.bias = (nn.Parameter(torch.zeros(filters, device=device))
                     if use_bias else None)

    def forward(self, x):
        y = _depthwise_nd(x, self.depthwise_kernel.to(x.dtype), self.strides,
                          self.padding, 3, self.dilation)
        y = conv_nd(y, self.pointwise_kernel.to(x.dtype), (1, 1, 1), "valid", 3)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return self.activation(y)
