"""Space-to-depth lane repacking (port of ``ku/nn/packed.py``), plain torch.

``ku`` packs each 2×2 pixel neighbourhood into channels, (B, H, W, C) →
(B, H/2, W/2, 4C), so that the TPU's 128-lane minor dimension is filled at
StyleGAN's narrow channels; every packed op computes the same function as
its unpacked counterpart with the same parameters. No path of the port
needs them: its StyleGAN models accept ``lane_packing`` and compute the
unpacked math, which is the same function. They are here for parity with
``ku``'s surface, channels-last like ``ku``, kernels in ``ku``'s HWIO layout,
on tensors of any device and no kernel of their own.

- :func:`space_to_depth` / :func:`depth_to_space`: the packing, phase-major
  channel order ``packed_c = (ph·2 + pw)·C + c``.
- :func:`tile_channels` / :func:`tile_channels_batched`: a per-channel
  vector (C,) or (B, C) repeated over the 4 phases.
- :func:`pack_conv2d_kernel` scatters a (kh, kw, C, F) kernel into the
  packed (Dh, Dw, 4C, 4F) kernel and its packed padding;
  :func:`packed_conv2d` is a SAME convolution on the packed layout;
  :func:`packed_depthwise_conv2d` a depthwise one (depth multiplier 1) by
  its block-diagonal dense kernel; :func:`packed_conv_transpose2x` the
  stride-2 SAME transposed convolution (``lax.conv_transpose``, kernel not
  flipped) by its per-output-phase decomposition.
- :func:`packed_pixel_norm`, :func:`packed_instance_stats`,
  :func:`packed_adain_with_style`: reductions over the C channels of each
  original pixel, or over space and phases for each channel, in ``ku``'s
  moment form; :func:`packed_avg_pool2x`: the 2×2 average pool, unpacked.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch.nn import functional as F

P = 2  # packing factor per spatial axis (2x2 -> 4 phases)
PHASES = P * P


def space_to_depth(x):
    """(B, H, W, C) → (B, H/2, W/2, 4C), phase-major channel order."""
    b, h, w, c = x.shape
    if h % P or w % P:
        raise ValueError(f"space_to_depth needs even H and W, got {h} x {w}")
    x = x.reshape(b, h // P, P, w // P, P, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // P, w // P, PHASES * c)


def depth_to_space(xp):
    """Inverse of :func:`space_to_depth`."""
    b, hp, wp, c4 = xp.shape
    c = c4 // PHASES
    x = xp.reshape(b, hp, wp, P, P, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp * P, wp * P, c)


def tile_channels(v):
    """A per-original-channel vector (C,) → packed channels (4C,)."""
    return v.repeat(PHASES)


def tile_channels_batched(v):
    """(B, C) per-channel vectors → (B, 4C) packed channels (phase-major)."""
    return v.repeat(1, PHASES)


def _axis_scatter(k: int, stride: int, pad_lo: int):
    """0/1 scatter S[dk, D, p, q] for one axis: output phase q reading
    original tap dk lands on packed input phase p at packed offset
    d = D + d_min. Returns (S, d_min, D)."""
    taps = []
    for q in range(P):
        for dk in range(k):
            v = stride * q + dk - pad_lo
            p = v % P
            taps.append((q, dk, p, (v - p) // P))
    d_min = min(t[3] for t in taps)
    d_span = max(t[3] for t in taps) - d_min + 1
    s = np.zeros((k, d_span, P, P), np.float32)
    for q, dk, p, d in taps:
        s[dk, d - d_min, p, q] = 1.0
    return s, d_min, d_span


def _same_pad_lo(k: int, stride: int) -> int:
    """XLA SAME's low-side padding for size-divisible inputs."""
    return max(k - stride, 0) // 2


def pack_conv2d_kernel(kernel, stride: int = 1):
    """Scatter an original (kh, kw, C, F) kernel into the packed (Dh, Dw, 4C,
    4F) one. Returns (packed kernel, (pad_h, pad_w)): each the packed input's
    (low padding, tap span) replacing the original SAME padding."""
    kh, kw, c, f = kernel.shape
    s_h, dmin_h, d_h = _axis_scatter(kh, stride, _same_pad_lo(kh, stride))
    s_w, dmin_w, d_w = _axis_scatter(kw, stride, _same_pad_lo(kw, stride))
    as_k = dict(dtype=kernel.dtype, device=kernel.device)
    wp = torch.einsum("hHpq,wWrs,hwcf->HWprcqsf", torch.as_tensor(s_h, **as_k),
                      torch.as_tensor(s_w, **as_k), kernel)
    return (wp.reshape(d_h, d_w, PHASES * c, PHASES * f),
            ((-dmin_h, d_h), (-dmin_w, d_w)))


def _packed_pad(pads, hp: int, stride: int, out_hp: int, d: int) -> Tuple[int, int]:
    lo = pads[0]
    hi = (out_hp - 1) * stride + d - hp - lo
    if hi < 0:  # the tap layout would give more rows than out_hp
        raise ValueError(f"packed padding {pads} at {hp} rows, stride {stride}")
    return lo, hi


def _conv_hwio(x, kernel, stride: int, pads):
    """``lax.conv_general_dilated`` NHWC × HWIO with explicit (lo, hi) pads."""
    (h_lo, h_hi), (w_lo, w_hi) = pads
    x = F.pad(x.permute(0, 3, 1, 2), (w_lo, w_hi, h_lo, h_hi))
    return F.conv2d(x, kernel.permute(3, 2, 0, 1), stride=stride).permute(0, 2, 3, 1)


def packed_conv2d(xp, kernel, stride: int = 1):
    """``conv2d(x, kernel, stride, SAME)`` on the packed layout: ``kernel`` is
    the ORIGINAL (kh, kw, C, F) kernel, ``xp`` the packed input (B, H/2, W/2,
    4C); the output is packed (B, H/(2s), W/(2s), 4F)."""
    b, hp, wp_, c4 = xp.shape
    if c4 != PHASES * kernel.shape[2]:
        raise ValueError(f"packed input {tuple(xp.shape)} does not fit kernel "
                         f"{tuple(kernel.shape)}")
    wp, (pads_h, pads_w) = pack_conv2d_kernel(kernel, stride)
    d_h, d_w = wp.shape[0], wp.shape[1]
    out_hp, out_wp = hp // stride, wp_ // stride
    return _conv_hwio(xp, wp, stride, (_packed_pad(pads_h, hp, stride, out_hp, d_h),
                                       _packed_pad(pads_w, wp_, stride, out_wp, d_w)))


def packed_depthwise_conv2d(xp, kernel):
    """SAME depthwise convolution on the packed layout. ``kernel``: Keras'
    (kh, kw, C, 1), embedded block-diagonal into a dense (kh, kw, C, C)
    kernel and packed (depth multiplier 1 only, the StyleGAN blur)."""
    kh, kw, c, mult = kernel.shape
    if mult != 1:
        raise ValueError("packed depthwise supports depth_multiplier=1")
    eye = torch.eye(c, dtype=kernel.dtype, device=kernel.device)
    return packed_conv2d(xp, kernel * eye[None, None], stride=1)


def _transpose2x_phase_kernel(kernel):
    """The (3, 3, C, 4F) stride-1 kernel whose output channels are the four
    output phases of ``lax.conv_transpose(x, kernel (4, 4, C, F), 2, SAME)``:
    output row r = 2i + q takes taps dh ≡ q (mod 2) at input offset
    t = (q + dh − 2) / 2 ∈ {−1, 0, 1}."""
    kh, kw, c, f = kernel.shape
    if (kh, kw) != (4, 4):
        raise ValueError("transpose2x expects the fused 4x4 kernel")
    s = np.zeros((4, 3, P), np.float32)  # [dh, t + 1, q]
    for q in range(P):
        for dh in range(4):
            v = q + dh - 2
            if v % 2 == 0:
                s[dh, v // 2 + 1, q] = 1.0
    s = torch.as_tensor(s, dtype=kernel.dtype, device=kernel.device)
    kt = torch.einsum("hHq,wWs,hwcf->HWcqsf", s, s, kernel)
    return kt.reshape(3, 3, c, PHASES * f)


def packed_conv_transpose2x(xp, kernel):
    """Stride-2 SAME transposed convolution on the packed layout → the packed
    2× output: ``space_to_depth(conv_transpose(depth_to_space(xp), kernel, 2,
    SAME))`` without the unpacked tensors. xp (B, H', W', 4C) → (B, 2H', 2W',
    4F)."""
    kt = _transpose2x_phase_kernel(kernel)
    y = packed_conv2d(xp, kt, stride=1)  # (B, H', W', 4·4F)
    # Its channels are (input phase, output phase, F); the input phases are
    # one resolution level up: back to space.
    b, hp, wp_, _ = y.shape
    f4 = kt.shape[-1]
    y = y.reshape(b, hp, wp_, P, P, f4).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, hp * P, wp_ * P, f4)


def _phase_group_matrix(c4: int, dtype, device):
    """(4C, 4C) block-diagonal ones: x @ M sums the C channels of each
    phase."""
    blocks = np.kron(np.eye(PHASES, dtype=np.float32),
                     np.ones((c4 // PHASES, c4 // PHASES), np.float32))
    return torch.as_tensor(blocks, dtype=dtype, device=device)


def packed_pixel_norm(xp, eps: float = 1e-8):
    """Pixel norm of each original pixel: over its C channels, not the
    phases. The sums in f32, as ``ku``'s dot with an f32 result."""
    c = xp.shape[-1] // PHASES
    m = _phase_group_matrix(xp.shape[-1], torch.float32, xp.device)
    sumsq = torch.square(xp).float() @ m
    return xp * torch.rsqrt(sumsq / c + eps).to(xp.dtype)


def packed_instance_stats(xp):
    """(mean, std) (B, C) of each (sample, original channel) over space and
    phases, in f32 and the moment form std = sqrt(E[x²] − E[x]²)."""
    b, _, _, c4 = xp.shape
    c = c4 // PHASES
    x32 = xp.float()
    m1 = x32.mean(dim=(1, 2)).reshape(b, PHASES, c).mean(dim=1)
    m2 = x32.square().mean(dim=(1, 2)).reshape(b, PHASES, c).mean(dim=1)
    var = (m2 - m1.square()).clamp_min(0.0)
    return m1.to(xp.dtype), torch.sqrt(var).to(xp.dtype)


def packed_adain_with_style(xp, style, eps: float = 1e-7):
    """StyleGAN's AdaIN (``AdaptiveINWithStyle``) on a packed tensor: style
    (B, 2C) packs (scale, bias) per original channel."""
    c = xp.shape[-1] // PHASES
    if style.dim() != 2 or style.shape[-1] != 2 * c:
        raise ValueError(f"style {tuple(style.shape)} does not fit packed "
                         f"{tuple(xp.shape)}: want (B, {2 * c})")
    mean, std = packed_instance_stats(xp)
    s = style.reshape(-1, 2, c)
    scale = tile_channels_batched(s[:, 0] + 1.0)[:, None, None]
    bias = tile_channels_batched(s[:, 1])[:, None, None]
    mean_t = tile_channels_batched(mean)[:, None, None]
    std_t = (tile_channels_batched(std) + eps)[:, None, None]
    return scale * ((xp - mean_t) / std_t) + bias


def packed_avg_pool2x(xp):
    """The 2×2 stride-2 average pool of the packed tensor, the mean over its
    phases: the UNPACKED half-resolution (B, H', W', C)."""
    b, hp, wp_, c4 = xp.shape
    return xp.reshape(b, hp, wp_, PHASES, c4 // PHASES).mean(dim=3)
