"""Transformer composite layers, and the flax-named Dense and LayerNorm.

Port of ``ku/nn/transformer.py``:

- :class:`Transformer`: 2 × (MHA + dropout + residual + LayerNorm), then a
  4×-wide swish FFN + dropout + residual + LayerNorm; forwards the
  attention options, including the KV-cache decode protocol (dense, paged,
  ring or int8 caches), int8 weights and a block-sparse ``block_mask``.
- :class:`InterferedTransformer`: the same conditioned on a per-sample
  embedding, tiled over the sequence and concatenated before a relu FFN.

Children carry flax's auto-names (``MultiHeadAttention_0/1``,
``LayerNorm_0/1/2``, ``Dense_0/1``) and :class:`Dense` / :class:`LayerNorm`
flax's parameter names and layouts (``kernel`` (in, out) applied as
``x @ kernel + bias``; ``scale``, ``bias``), so the state dict of a block is
``ku``'s params under '.'-joined names. Every LayerNorm uses eps 1e-6, as
``ku`` does (explicitly in ``Transformer``, flax's default in
``InterferedTransformer``).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn
from torch.nn import functional as F

from ku_torch.dist.parallel import parallel_matmul
from ku_torch.nn.attention import (
    SIMILARITY_TYPE_SCALED,
    MultiHeadAttention,
    scoped,
    trunc_normal,
)
from ku_torch.nn.quant import QuantDense

# flax's lecun_normal draws a normal cut at ±2 and rescales it by this
# (the standard deviation of N(0, 1) truncated to [-2, 2]).
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` (in, out) with lecun-normal init,
    ``bias`` zeros (none with ``use_bias=False``); ``y = x @ kernel + bias``.
    ``parallel`` splits the product over a process group
    (:func:`ku_torch.dist.parallel.parallel_matmul`)."""

    def __init__(self, in_features: int, features: int, *, device="cuda",
                 dtype=None, generator: Optional[torch.Generator] = None,
                 use_bias: bool = True):
        super().__init__()
        std = math.sqrt(1.0 / in_features) / _TRUNC_STD
        self.kernel = nn.Parameter(trunc_normal((in_features, features), std,
                                                generator, device, dtype))
        self.bias = (nn.Parameter(torch.zeros(features, device=device, dtype=dtype))
                     if use_bias else None)
        self.parallel = None  # a ku_torch.dist.parallel.TensorParallel when split

    def forward(self, x):
        y = parallel_matmul(self, x, self.kernel)
        return y if self.bias is None else y + self.bias


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: statistics in f32 with the
    fast variance E[x²] − E[x]² (clipped at 0), ``scale`` ones, ``bias``
    zeros, result in x's dtype."""

    def __init__(self, features: int, epsilon: float = 1e-6, *, device="cuda",
                 dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(features, device=device, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.float()
        return ((xf - mean) * mul + self.bias.float()).to(x.dtype)


class Transformer(nn.Module):
    """Transformer encoder block, as ``ku.nn.Transformer``.

    Takes ``ku``'s fields; the input width is ``d_output`` (the residuals
    need it). ``device``, ``dtype`` and ``generator`` place and draw the
    initial weights. The call's ``block_mask`` goes to both attention
    sublayers, as in ``ku``, and with it the layer's ``causal`` must be the
    mask's and ``window`` / ``global_prefix`` unset. ``quant_weights``
    makes the four projections of each attention sublayer and the two FFN
    kernels int8 (``Dense_0`` / ``Dense_1`` become
    :class:`ku_torch.nn.quant.QuantDense`), as in ``ku``."""

    def __init__(self, num_head: int, d_output: int, dropout_rate: float = 0.0,
                 similarity_type: str = SIMILARITY_TYPE_SCALED,
                 layer_norm_f: bool = True, use_flash: bool = False,
                 causal: bool = False, window: Optional[int] = None,
                 num_kv_head: Optional[int] = None,
                 max_decode_len: Optional[int] = None, global_prefix: int = 0,
                 kv_cache_dtype: Optional[str] = None,
                 kv_page_size: Optional[int] = None,
                 kv_num_pages: Optional[int] = None, rope: bool = False,
                 rope_base: float = 10000.0,
                 logit_softcap: Optional[float] = None,
                 flash_decode: Optional[bool] = None,
                 quant_weights: Union[bool, str] = False, *, device="cuda",
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.layer_norm_f = layer_norm_f
        kw = dict(device=device, dtype=dtype)
        for j in range(2):
            self.add_module(f"MultiHeadAttention_{j}", MultiHeadAttention(
                num_head, d_output, dropout_rate,
                similarity_type=similarity_type, use_flash=use_flash,
                causal=causal, window=window, num_kv_head=num_kv_head,
                max_decode_len=max_decode_len, global_prefix=global_prefix,
                kv_cache_dtype=kv_cache_dtype, kv_page_size=kv_page_size,
                kv_num_pages=kv_num_pages, rope=rope, rope_base=rope_base,
                logit_softcap=logit_softcap, flash_decode=flash_decode,
                quant_weights=quant_weights, generator=generator, **kw))
        if layer_norm_f:
            for j in range(3):
                self.add_module(f"LayerNorm_{j}", LayerNorm(d_output, 1e-6, **kw))
        if quant_weights:
            # int8 FFN kernels under flax's names, as ku's QuantDense.
            aq = quant_weights == "w8a8"
            self.Dense_0 = QuantDense(d_output, 4 * d_output, act_quant=aq, **kw)
            self.Dense_1 = QuantDense(4 * d_output, d_output, act_quant=aq, **kw)
        else:
            self.Dense_0 = Dense(d_output, 4 * d_output, generator=generator, **kw)
            self.Dense_1 = Dense(4 * d_output, d_output, generator=generator, **kw)

    def _drop(self, x, deterministic):
        if self.dropout_rate > 0.0 and not deterministic:
            return F.dropout(x, p=self.dropout_rate, training=True)
        return x

    def forward(self, inputs, deterministic: bool = True, decode: bool = False,
                segment_ids=None, block_mask=None, prompt_lengths=None,
                cache: Optional[dict] = None, scope: str = ""):
        """``inputs = [x(, mask)]``, x (B, N, d_output). Returns (B, N,
        d_output), or ``(y, cache)`` with ``decode=True`` (see
        :meth:`MultiHeadAttention.forward`; ``scope`` is this block's path
        in the cache)."""
        x, m = inputs[0], inputs[1] if len(inputs) > 1 else None
        if decode and cache is None:
            cache = {}

        def attn_block(y, j):
            mha = getattr(self, f"MultiHeadAttention_{j}")
            y2 = mha([y, y, y, m], deterministic=deterministic, decode=decode,
                     segment_ids=segment_ids, block_mask=block_mask,
                     prompt_lengths=prompt_lengths, cache=cache,
                     scope=scoped(scope, f"MultiHeadAttention_{j}"))
            if decode:
                y2 = y2[0]
            y2 = y + self._drop(y2, deterministic)
            if self.layer_norm_f:
                y2 = getattr(self, f"LayerNorm_{j}")(y2)
            return y2

        x3 = attn_block(attn_block(x, 0), 1)
        x4 = self.Dense_1(F.silu(self.Dense_0(x3)))
        x4 = x3 + self._drop(x4, deterministic)
        if self.layer_norm_f:
            x4 = self.LayerNorm_2(x4)
        return (x4, cache) if decode else x4


class InterferedTransformer(nn.Module):
    """Transformer block conditioned on a per-sample embedding, as
    ``ku.nn.InterferedTransformer``: ``inputs = [embedded (B, d_embed),
    x (B, N, d_output)(, mask)]``. ``d_embed`` defaults to ``d_output``."""

    def __init__(self, num_head: int, d_output: int, dropout_rate: float = 0.0,
                 similarity_type: str = SIMILARITY_TYPE_SCALED,
                 layer_norm_f: bool = True, *, d_embed: Optional[int] = None,
                 device="cuda", dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.layer_norm_f = layer_norm_f
        d_embed = d_output if d_embed is None else d_embed
        kw = dict(device=device, dtype=dtype)
        # flax's creation order names the embedding's LayerNorm first.
        if layer_norm_f:
            self.LayerNorm_0 = LayerNorm(d_embed, **kw)
        for j in range(2):
            self.add_module(f"MultiHeadAttention_{j}", MultiHeadAttention(
                num_head, d_output, dropout_rate,
                similarity_type=similarity_type, generator=generator, **kw))
        if layer_norm_f:
            for j in (1, 2, 3):
                self.add_module(f"LayerNorm_{j}", LayerNorm(d_output, **kw))
        self.Dense_0 = Dense(d_output + d_embed, d_output, generator=generator, **kw)
        self.Dense_1 = Dense(d_output, d_output, generator=generator, **kw)

    def forward(self, inputs, deterministic: bool = True):
        embedded, x = inputs[0], inputs[1]
        m = inputs[2] if len(inputs) > 2 else None
        emb = embedded[:, None, :].expand(-1, x.shape[1], -1)
        if self.layer_norm_f:
            emb = self.LayerNorm_0(emb)

        def attn_block(y, j):
            y2 = getattr(self, f"MultiHeadAttention_{j}")(
                [y, y, y, m], deterministic=deterministic)
            y2 = y + y2
            if self.layer_norm_f:
                y2 = getattr(self, f"LayerNorm_{j + 1}")(y2)
            return y2

        x3 = attn_block(attn_block(x, 0), 1)
        x4 = self.Dense_1(torch.relu(self.Dense_0(torch.cat([x3, emb], dim=-1))))
        x4 = x3 + x4
        if self.layer_norm_f:
            x4 = self.LayerNorm_3(x4)
        if self.dropout_rate > 0.0 and not deterministic:
            x4 = F.dropout(x4, p=self.dropout_rate, training=True)
        return x4
