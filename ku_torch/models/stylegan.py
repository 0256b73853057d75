"""StyleGAN: mapping net, synthesis net, generator and discriminator
(port of ``ku/models/stylegan.py``), channels-last.

Children and parameters carry ``ku``'s names and layouts (``map/
map_dense_0/kernel`` (in, out), ``synthesis/conv_4x4/kernel`` HWIO,
``map/label_embed/embedding``, ...), so ``load_state_dict(
state_dict_from_tree(params, batch_stats=...), strict=True)`` loads
``ku``'s variables as they are; ``truncation.moving_mean`` is a buffer.

- ``dtype=torch.bfloat16`` computes in bf16 with float32 parameters;
  ``to_rgb`` and the discriminator's ``dense_out`` compute in float32, as
  in ``ku`` (at least float32: a float64 model stays float64 there, which
  the card's checks use as their reference).
- ``lane_packing`` / ``lane_pack_min`` are accepted and the unpacked math
  runs: ``ku``'s packed layout is a TPU lane trick with the same parameter
  tree and the same function.
- The upsampling below 128 px is ``jax.image.resize(..., "bilinear")``, which
  for 2× equals ``F.interpolate(mode="bilinear", align_corners=False)``,
  edges included; the discriminator flattens in NHWC order before
  ``dense_1``.
- Noise (``_ApplyNoise``, one (H, W, C) field shared by the batch) and style
  mixing draw from the ``generator`` passed to ``forward`` (``ku``'s
  ``'noise'`` and ``'style'`` streams); ``deterministic=True`` draws
  nothing.

The learned constant and the per-channel noise weights are parameters, as
in ``ku``. Entry points build on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ku_torch.nn.convolution import (
    BlurDepthwiseConv2D,
    EqualizedLRConv2D,
    FusedEqualizedLRConv2D,
    FusedEqualizedLRConv2DTranspose,
    to_channels_first,
    to_channels_last,
)
from ku_torch.dist.parallel import parallel_matmul
from ku_torch.nn.common import leaky_relu
from ku_torch.nn.core import EqualizedLRDense
from ku_torch.nn.normalization import AdaptiveINWithStyle, pixel_norm
from ku_torch.nn.transformer import Dense
from ku_torch.nn.style import (
    MinibatchStddevConcat,
    StyleMixingRegularization,
    TruncationTrick,
)


def cal_num_chs(layer_idx: int, ch_base: int = 1024, max_ch: int = 512) -> int:
    """Channels of a synthesis layer: ``min(ch_base / 2^layer, max_ch)``."""
    return int(min(ch_base / (2.0 ** layer_idx), max_ch))


def _at_least_f32(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _leaky(x):
    return leaky_relu(x, 0.2)


def upsample_bilinear_2x(x):
    """(N, H, W, C) → (N, 2H, 2W, C): ``jax.image.resize(..., "bilinear")``,
    which at 2× is half-pixel-centred interpolation with the edges
    clamped."""
    return to_channels_last(F.interpolate(to_channels_first(x), scale_factor=2,
                                          mode="bilinear", align_corners=False,
                                          antialias=False))


class _FlaxDense(Dense):
    """flax ``nn.Dense`` computed in the input's dtype (the mapping net casts
    its input to its ``dtype`` first)."""

    def forward(self, x):
        return parallel_matmul(self, x, self.kernel.to(x.dtype)) + self.bias.to(x.dtype)


class _FlaxEmbed(nn.Module):
    """flax ``nn.Embed``: ``embedding`` (num_embeddings, features) drawn from
    N(0, 1/features)."""

    def __init__(self, num_embeddings: int, features: int, dtype=None, *, device,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        table = torch.empty((num_embeddings, features), device=device)
        self.embedding = nn.Parameter(nn.init.normal_(
            table, std=1.0 / math.sqrt(features), generator=generator))

    def forward(self, ids):
        table = self.embedding if self.dtype is None else self.embedding.to(self.dtype)
        return table[ids]


class _ApplyNoise(nn.Module):
    """``x + N(0, 1)·w_c``: one (H, W, C) field for the whole batch."""

    def __init__(self, channels: int, *, device):
        super().__init__()
        self.noise_weight = nn.Parameter(torch.ones(channels, device=device))

    def forward(self, x, deterministic: bool = False, generator=None):
        if deterministic:
            return x
        n = torch.randn(x.shape[1:], generator=generator, device=x.device,
                        dtype=x.dtype)
        return x + n[None] * self.noise_weight.reshape(1, 1, 1, -1)


class MappingNetwork(nn.Module):
    """z (+ label) → dlatents broadcast to ``num_broadcast_layers``:
    (N, num_broadcast_layers, dlatent_dim)."""

    def __init__(self, latent_dim: int = 64, dlatent_dim: int = 512,
                 dense1_dim: int = 512, num_mapping_layers: int = 8,
                 num_broadcast_layers: int = 12, num_classes: int = 0,
                 label_usage: bool = True, dtype: Optional[torch.dtype] = None, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_mapping_layers = num_mapping_layers
        self.num_broadcast_layers = num_broadcast_layers
        self.label_usage = label_usage
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        width = latent_dim
        if label_usage:
            self.label_embed = _FlaxEmbed(num_classes, latent_dim, dtype=dtype, **kw)
            width += latent_dim
        for i in range(num_mapping_layers - 1):
            self.add_module(f"map_dense_{i}", _FlaxDense(width, dense1_dim, **kw))
            width = dense1_dim
        self.map_output = _FlaxDense(width, dlatent_dim, **kw)

    def forward(self, z, label=None):
        x = z if self.dtype is None else z.to(self.dtype)
        if self.label_usage:
            ids = torch.as_tensor(label, device=x.device).reshape(-1).long()
            x = torch.cat([x, self.label_embed(ids)], dim=-1)
        x = pixel_norm(x)
        for i in range(self.num_mapping_layers - 1):
            x = _leaky(getattr(self, f"map_dense_{i}")(x))
        x = _leaky(self.map_output(x))
        return x[:, None, :].expand(-1, self.num_broadcast_layers, -1)


class SynthesisNetwork(nn.Module):
    """Broadcast dlatents (N, num_layers, dlatent_dim) → image (N, res, res,
    3) in [-1, 1]. Maps of 128 px and more upsample through the fused
    transposed conv, smaller ones through bilinear resize and a conv."""

    def __init__(self, resolution: int = 128, ch_base: int = 1024,
                 max_ch: int = 512, dlatent_dim: int = 512,
                 dtype: Optional[torch.dtype] = None, lane_packing: bool = False,
                 lane_pack_min: int = 64, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        res_log2 = int(math.log2(resolution))
        if resolution != 2 ** res_log2 or resolution < 4:
            raise ValueError(f"resolution {resolution} is not a power of 2 >= 4")
        if lane_pack_min < 8:
            raise ValueError(f"lane_pack_min {lane_pack_min} < 8")
        self.resolution, self.dtype = resolution, dtype
        self.lane_packing, self.lane_pack_min = lane_packing, lane_pack_min
        nch = lambda i: cal_num_chs(i, ch_base, max_ch)  # noqa: E731
        kw = dict(device=device, generator=generator)
        conv_kw = dict(padding="same", dtype=dtype, **kw)
        self.const_input = nn.Parameter(torch.ones((1, 4, 4, nch(1)), device=device))
        self._add_style_block(0, dlatent_dim, nch(1), **kw)
        self.conv_4x4 = EqualizedLRConv2D(nch(1), nch(1), 3, **conv_kw)
        self._add_style_block(1, dlatent_dim, nch(1), **kw)
        for res in range(3, res_log2 + 1):
            c_in, c = nch(res - 2), nch(res - 1)
            if 2 ** res >= 128:
                self.add_module(f"up_fused_{res}", FusedEqualizedLRConv2DTranspose(
                    c_in, c, 3, strides=2, **conv_kw))
            else:
                self.add_module(f"up_conv_{res}", EqualizedLRConv2D(c_in, c, 3, **conv_kw))
            self.add_module(f"blur_{res}", BlurDepthwiseConv2D(c, device=device))
            self._add_style_block(res * 2 - 4, dlatent_dim, c, **kw)
            self.add_module(f"conv_{res}", EqualizedLRConv2D(c, c, 3, **conv_kw))
            self._add_style_block(res * 2 - 3, dlatent_dim, c, **kw)
        self.to_rgb = EqualizedLRConv2D(nch(res_log2 - 1), 3, 1, activation="tanh",
                                        padding="same", **kw)

    def _add_style_block(self, i, dlatent_dim, ch, *, device, generator):
        self.add_module(f"style_dense_{i}", EqualizedLRDense(
            dlatent_dim, ch * 2, dtype=self.dtype, device=device, generator=generator))
        self.add_module(f"noise_{i}", _ApplyNoise(ch, device=device))
        self.add_module(f"adain_{i}", AdaptiveINWithStyle(epsilon=1e-8))

    def _style_block(self, x, dlatents, i, deterministic, generator):
        """noise → LReLU → pixel norm → AdaIN(style)."""
        style = getattr(self, f"style_dense_{i}")(dlatents[:, i])
        x = getattr(self, f"noise_{i}")(x, deterministic, generator)
        x = pixel_norm(_leaky(x))
        return getattr(self, f"adain_{i}")([x, style])

    def forward(self, dlatents, deterministic: bool = False,
                generator: Optional[torch.Generator] = None):
        dtype = self.dtype or dlatents.dtype
        dlatents = dlatents.to(dtype)
        x = self.const_input.to(dtype).expand(dlatents.shape[0], -1, -1, -1)
        x = self._style_block(x, dlatents, 0, deterministic, generator)
        x = self.conv_4x4(x)
        x = self._style_block(x, dlatents, 1, deterministic, generator)
        for res in range(3, int(math.log2(self.resolution)) + 1):
            if 2 ** res >= 128:
                x = getattr(self, f"up_fused_{res}")(x)
            else:
                x = getattr(self, f"up_conv_{res}")(upsample_bilinear_2x(x))
            x = getattr(self, f"blur_{res}")(x)
            x = self._style_block(x, dlatents, res * 2 - 4, deterministic, generator)
            x = getattr(self, f"conv_{res}")(x)
            x = self._style_block(x, dlatents, res * 2 - 3, deterministic, generator)
        return self.to_rgb(x.to(_at_least_f32(x.dtype)))


class StyleGANGenerator(nn.Module):
    """Mapping (one pass over [z1; z2]) → style mixing → truncation →
    synthesis. Call with ``(z1, label, z2)`` when ``label_usage``, else
    ``(z1, z2)``; without ``deterministic`` it draws noise and the mixing
    from ``generator`` and updates ``truncation.moving_mean``."""

    def __init__(self, resolution: int = 128, ch_base: int = 1024,
                 max_ch: int = 512, latent_dim: int = 64, dlatent_dim: int = 512,
                 dense1_dim: int = 512, num_mapping_layers: int = 8,
                 num_classes: int = 0, label_usage: bool = True,
                 mixing_prob: Optional[float] = 0.9, trunc_psi: float = 0.7,
                 trunc_cutoff: Optional[int] = 8, trunc_momentum: float = 0.99,
                 dtype: Optional[torch.dtype] = None, lane_packing: bool = False,
                 lane_pack_min: int = 64, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.label_usage = label_usage
        kw = dict(device=device, generator=generator)
        self.map = MappingNetwork(
            latent_dim=latent_dim, dlatent_dim=dlatent_dim, dense1_dim=dense1_dim,
            num_mapping_layers=num_mapping_layers,
            num_broadcast_layers=int(math.log2(resolution)) * 2 - 2,
            num_classes=num_classes, label_usage=label_usage, dtype=dtype, **kw)
        self.style_mixing = StyleMixingRegularization(mixing_prob=mixing_prob)
        self.truncation = TruncationTrick(dlatent_dim, psi=trunc_psi,
                                          cutoff=trunc_cutoff,
                                          momentum=trunc_momentum, device=device)
        self.synthesis = SynthesisNetwork(
            resolution=resolution, ch_base=ch_base, max_ch=max_ch,
            dlatent_dim=dlatent_dim, dtype=dtype, lane_packing=lane_packing,
            lane_pack_min=lane_pack_min, **kw)

    def forward(self, inputs, deterministic: bool = False,
                generator: Optional[torch.Generator] = None):
        if self.label_usage:
            z1, label, z2 = inputs
        else:
            (z1, z2), label = inputs, None
        n = z1.shape[0]
        ll = None
        if label is not None:
            label = torch.as_tensor(label, device=z1.device)
            ll = torch.cat([label, label], dim=0)
        dd = self.map(torch.cat([z1, z2], dim=0), ll)
        d = self.style_mixing([dd[:n], dd[n:]], deterministic, generator)
        d = self.truncation(d, deterministic)
        return self.synthesis(d, deterministic, generator)


class StyleGANDiscriminator(nn.Module):
    """Discriminator pyramid; call with ``(images, labels)`` when
    ``label_usage`` (images (N, res, res, 3), labels (N, 1) projected onto
    the logit), else ``images``. Returns (N, 1) logits in float32.
    Dropout (``dropout_rate``) draws from ``generator`` when not
    ``deterministic``."""

    def __init__(self, resolution: int = 128, ch_base: int = 1024,
                 max_ch: int = 512, dropout_rate: float = 0.0,
                 label_usage: bool = True, dtype: Optional[torch.dtype] = None,
                 lane_packing: bool = False, lane_pack_min: int = 64, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if lane_pack_min < 8:
            raise ValueError(f"lane_pack_min {lane_pack_min} < 8")
        self.resolution, self.dropout_rate = resolution, dropout_rate
        self.label_usage, self.dtype = label_usage, dtype
        self.lane_packing, self.lane_pack_min = lane_packing, lane_pack_min
        res_log2 = int(math.log2(resolution))
        nch = lambda i: cal_num_chs(i, ch_base, max_ch)  # noqa: E731
        kw = dict(device=device, generator=generator)
        conv_kw = dict(padding="same", dtype=dtype, **kw)
        self.from_rgb = EqualizedLRConv2D(3, nch(res_log2 - 1), 1, **conv_kw)
        for res in range(res_log2, 2, -1):
            c, c_out = nch(res - 1), nch(res - 2)
            self.add_module(f"conv_{res}_a", EqualizedLRConv2D(c, c, 3, **conv_kw))
            self.add_module(f"blur_{res}", BlurDepthwiseConv2D(c, device=device))
            conv_b = FusedEqualizedLRConv2D if 2 ** res * 2 >= 128 else EqualizedLRConv2D
            strides = 2 if conv_b is FusedEqualizedLRConv2D else 1
            self.add_module(f"conv_{res}_b", conv_b(c, c_out, 3, strides=strides,
                                                    **conv_kw))
        self.mbstd = MinibatchStddevConcat()
        self.conv_4x4 = EqualizedLRConv2D(nch(1) + 1, nch(1), 3, **conv_kw)
        self.dense_1 = EqualizedLRDense(4 * 4 * nch(1), nch(0), dtype=dtype, **kw)
        self.dense_out = EqualizedLRDense(nch(0), 1, **kw)

    def forward(self, inputs, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        if self.label_usage:
            images, labels = inputs
        else:
            images, labels = inputs, None
        if self.dtype is not None:
            images = images.to(self.dtype)
        x = _leaky(self.from_rgb(images))
        for res in range(int(math.log2(self.resolution)), 2, -1):
            x = _leaky(getattr(self, f"conv_{res}_a")(x))
            x = getattr(self, f"blur_{res}")(x)
            x = getattr(self, f"conv_{res}_b")(x)
            if 2 ** res * 2 < 128:
                x = to_channels_last(F.avg_pool2d(to_channels_first(x), 2, 2))
            x = _leaky(x)
        x = self.mbstd(x)
        x = _leaky(self.conv_4x4(x))
        x = _leaky(self.dense_1(x.reshape(x.shape[0], -1)))  # NHWC order
        if self.dropout_rate and not deterministic:
            keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.dropout_rate
            x = torch.where(keep, x / (1.0 - self.dropout_rate), 0.0)
        x = self.dense_out(x.to(_at_least_f32(x.dtype)))
        if labels is not None:
            labels = torch.as_tensor(labels, device=x.device, dtype=x.dtype)
            x = x * labels.reshape(-1, 1)
        return x.sum(dim=1, keepdim=True)
