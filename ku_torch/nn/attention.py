"""Multi-head attention with five similarity types, and its KV-cache decode.

Port of ``ku/nn/attention.py``. Parameters keep ``ku``'s names and layouts
(``W_Q`` (d, d), ``W_K``/``W_V`` (d, d/H·Hkv), ``W_multi_head`` (d, d_out),
no biases, applied as ``x @ W``), so ``load_state_dict`` takes
:func:`ku_torch.utility.state_dict_from_tree` of ``ku``'s params as it is.

Decode (``decode=True``) follows ``ku``'s cache protocol with an explicit
cache: a dict keyed like ``ku``'s ``cache`` collection, created on first use
(each missing entry on its own), every tensor with the slot axis minor:

- dense: ``{scope}/cached_key`` (B, Hkv, D/H, max_decode_len) and
  ``{scope}/cached_value``;
- paged (``kv_page_size=pg``): a pool ``{scope}/pages_k`` (NP, Hkv, D/H, pg)
  and ``{scope}/pages_v`` shared by all rows, and ``{scope}/page_table``
  (B, MP) int32 naming the pool page of each of a row's MP =
  ceil(max_decode_len/pg) logical pages. NP is ``kv_num_pages``, or B·MP,
  and the default table is the identity ``min(b·MP + j, NP-1)`` (it aliases
  pages, with a warning, when NP < B·MP: a scheduler such as
  :class:`ku_torch.nn.ContinuousBatcher` then writes the table);
- int8 (``kv_cache_dtype='int8'``): the K/V entries hold int8, quantised
  per (token, head) symmetrically, beside f32 ``{scope}/key_scale`` /
  ``value_scale`` (B, Hkv, max_decode_len), or ``key_scale_pages`` /
  ``value_scale_pages`` (NP, Hkv, pg) for a pool. Attention sees the
  dequantised values cast to the K/V dtype, except the per-token reads,
  which fold the scales into scores and probabilities as ``ku`` does;
- ``{scope}/cache_index`` (B,) int32.

The forward writes this chunk's K/V into the dict's tensors IN PLACE, at
each row's index, and returns ``(y, cache)`` with ``cache_index`` advanced.
L > 1 is a prefill, ragged with ``prompt_lengths``; L = 1 is one token per
row. A paged write lands only in the pages that the row's own table names
for its positions: so a caller that shares one pool between several cache
dicts (the batcher's sub-batch admissions) changes no page that the rows it
passes do not own. A position past a dense cache's end is clamped to its
last slot, one past a table's end (MP·pg) is dropped, as ``ku`` documents
it (``ku``'s per-token write for pools above 8 MB instead lands such a
position in pool page 0).

The kernels on this path are chosen by the tensor's device, never by
size: ``use_flash`` routes prefill (over the gathered, dequantised view for
a pool or an int8 cache) and the non-decode scaled path through
:func:`ku_torch.kernels.flash_attention.flash_attention`, which is
differentiable (the flash backward kernels) when gradients are wanted, as
in training, and forward-only under ``torch.no_grad()``; the per-token
read goes through :func:`ku_torch.kernels.decode_attention.decode_attention`
or, for a pool, ``decode_attention_paged`` (int8 caches with their scales)
unless ``flash_decode=False`` asks for the plain reads: ``ku``'s masked
read, or for a pool its page scan. On a CUDA tensor each launches its
kernel (or raises); on a CPU tensor each takes its plain version.

``block_mask`` (a :class:`ku_torch.kernels.sparse_attention.BlockMask`
from ``make_block_mask``) routes the non-decode scaled path, after RoPE,
through :func:`ku_torch.kernels.sparse_attention.sparse_attention`: the
block-sparse kernels on a CUDA tensor (forward, and dq and dk/dv when
gradients are wanted), their plain versions on a CPU tensor. The mask
carries the pattern, causality included: the layer's ``causal`` must agree
and its ``window`` and ``global_prefix`` stay unset; dropout, segment ids,
softcap and decode are refused with ``ku``'s messages.

The ring cache (``window`` with ``decode=True``, StreamingLLM) holds
``global_prefix`` sink slots and ``window`` rolling ones, for decode of
any length: ``{scope}/cached_key`` / ``cached_value`` are slot-MAJOR
(B, Hkv, gp + window, D/H) (and int8 scales (B, Hkv, gp + window)), beside
``{scope}/cache_pos`` (B, gp + window) int32, each slot's global position
(−1 while empty). A prefill needs an empty cache and equal lengths: it
attends the raw prompt (banded flash attention with ``use_flash``, which
takes no sinks, else the dense pass with the sinks' escape) and then keeps
the last position written to each slot. A token goes to slot
gp + (i − gp) mod window past the sinks and attends the occupied slots that
are sinks or inside the window, in plain torch on every device: ``ku``
reads the ring with XLA, never with its decode kernel.

``parallel`` (a :class:`ku_torch.dist.parallel.TensorParallel`, set by
:func:`ku_torch.dist.parallel.shard_heads_`) makes the layer compute its
rank's heads from its rank's columns of ``W_Q`` / ``W_K`` / ``W_V`` and rows
of ``W_multi_head``, the output closed by an all-reduce; its caches hold
those heads.

``quant_weights`` (True, or ``"w8a8"``) makes ``W_Q``, ``W_K``, ``W_V`` and
``W_multi_head`` int8 with f32 ``<name>_scale`` beside each, filled by
:func:`ku_torch.nn.quant.quantize_weights`; ``W_gen_S`` / ``W_add_S_*`` stay
float.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Union

import torch
from torch import nn
from torch.nn import functional as F

from ku_torch.dist.parallel import copy_to, reduce_sum
from ku_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_paged,
    gather_pages,
)
from ku_torch.kernels.flash_attention import flash_attention
from ku_torch.kernels.sparse_attention import sparse_attention
from ku_torch.nn.quant import _127, quant_project, quant_weight

SIMILARITY_TYPE_DIFF_ABS = "diff_abs"
SIMILARITY_TYPE_PLAIN = "plain"
SIMILARITY_TYPE_SCALED = "scaled"
SIMILARITY_TYPE_GENERAL = "general"
SIMILARITY_TYPE_ADDITIVE = "additive"

_SIMILARITY_TYPES = (
    SIMILARITY_TYPE_DIFF_ABS,
    SIMILARITY_TYPE_PLAIN,
    SIMILARITY_TYPE_SCALED,
    SIMILARITY_TYPE_GENERAL,
    SIMILARITY_TYPE_ADDITIVE,
)
_MASKED = -1e30


def scoped(scope: str, name: str) -> str:
    """``ku``'s '/'-joined variable path: ``scope/name`` (``name`` at top)."""
    return f"{scope}/{name}" if scope else name


def trunc_normal(shape, std, generator=None, device=None, dtype=None):
    """flax's ``truncated_normal(stddev=std)``: N(0, std²) cut at ±2 std."""
    w = torch.empty(shape, device=device, dtype=dtype)
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def apply_rope(x, pos, base: float = 10000.0):
    """Rotate head vectors by absolute positions (RoPE, GPT-NeoX rotate-half
    convention). ``x``: (B, H, L, D) with D even; ``pos``: (L,) shared or
    (B, L) per-row integer positions. Computed in f32, returned in x's dtype."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"rope needs an even head dim, got {d}")
    pos = torch.as_tensor(pos, device=x.device)
    if pos.dim() not in (1, 2):
        raise ValueError(f"pos must be (L,) or (B, L), got shape "
                         f"{tuple(pos.shape)}")
    half = d // 2
    freq = base ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos[..., None].to(torch.float32) * freq
    ang = ang[None, None] if ang.dim() == 2 else ang[:, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).to(x.dtype)


class MultiHeadAttention(nn.Module):
    """MHA over ``inputs = [Q, K, V, M]``, as ``ku.nn.MultiHeadAttention``.

    The constructor takes ``ku``'s fields plus what flax infers from the
    first call: ``d_input`` (the width of Q, K and V; ``d_output`` by
    default), ``device``, ``dtype`` and the ``generator`` that draws the
    initial weights (flax's truncated normal, std 0.02)."""

    def __init__(self, num_head: int, d_output: int, dropout_rate: float = 0.0,
                 similarity_type: str = SIMILARITY_TYPE_SCALED,
                 use_mask: bool = False, use_flash: bool = False,
                 causal: bool = False, window: Optional[int] = None,
                 num_kv_head: Optional[int] = None,
                 max_decode_len: Optional[int] = None,
                 global_prefix: int = 0,
                 kv_cache_dtype: Optional[str] = None,
                 kv_page_size: Optional[int] = None,
                 kv_num_pages: Optional[int] = None,
                 logit_softcap: Optional[float] = None,
                 rope: bool = False, rope_base: float = 10000.0,
                 flash_decode: Optional[bool] = None,
                 quant_weights: Union[bool, str] = False, *,
                 d_input: Optional[int] = None, device="cuda", dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if quant_weights not in (False, True, "w8a8"):
            raise ValueError("quant_weights must be False, True or 'w8a8', got "
                             f"{quant_weights!r}")
        self.quant_weights = quant_weights
        self.num_head = num_head
        self.d_output = d_output
        self.dropout_rate = dropout_rate
        self.similarity_type = similarity_type
        self.use_mask = use_mask
        self.use_flash = use_flash
        self.causal = causal
        self.window = window
        self.num_kv_head = num_kv_head
        self.max_decode_len = max_decode_len
        self.global_prefix = global_prefix
        self.kv_cache_dtype = kv_cache_dtype
        self.kv_page_size = kv_page_size
        self.kv_num_pages = kv_num_pages
        self.logit_softcap = logit_softcap
        self.rope = rope
        self.rope_base = rope_base
        self.flash_decode = flash_decode
        # A ku_torch.dist.parallel.TensorParallel when the heads are split
        # over a process group (head-parallel serving).
        self.parallel = None

        d = d_output if d_input is None else d_input
        h = num_head
        hkv = num_kv_head if num_kv_head is not None else h
        if d % h or h % hkv:
            raise ValueError(f"width {d} must split into {h} heads, and {h} "
                             f"heads into {hkv} kv heads")
        dh = d // h
        kw = dict(generator=generator, device=device, dtype=dtype)
        shapes = dict(W_Q=(d, d), W_K=(d, dh * hkv), W_V=(d, dh * hkv),
                      W_multi_head=(d, d_output))
        for name, shape in shapes.items():
            if quant_weights:
                # ku's quantized template: int8 zeros and f32 unit scales,
                # filled by quantize_weights.
                w, scale = quant_weight(shape, device)
                setattr(self, name, w)
                setattr(self, name + "_scale", scale)
            else:
                setattr(self, name, nn.Parameter(trunc_normal(shape, 0.02, **kw)))
        if similarity_type == SIMILARITY_TYPE_GENERAL:
            self.W_gen_S = nn.Parameter(trunc_normal((dh, dh), 0.02, **kw))
        elif similarity_type == SIMILARITY_TYPE_ADDITIVE:
            self.W_add_S_Q = nn.Parameter(trunc_normal((dh, dh), 0.02, **kw))
            self.W_add_S_K = nn.Parameter(trunc_normal((dh, dh), 0.02, **kw))

    def _cap(self, s):
        if self.logit_softcap is None:
            return s
        return self.logit_softcap * torch.tanh(s / self.logit_softcap)

    def _validate(self, decode, segment_ids, block_mask, prompt_lengths,
                  deterministic):
        if self.similarity_type not in _SIMILARITY_TYPES:
            raise ValueError(f"similarity_type {self.similarity_type!r} is not valid.")
        if self.window is not None and not self.causal:
            raise ValueError("window requires causal=True")
        scaled = (self.similarity_type == SIMILARITY_TYPE_SCALED
                  and not self.use_mask)
        if block_mask is not None:
            # The pattern, causality included, is the mask's: the layer's
            # causal flag must agree and its window must be unset.
            if not scaled or decode or segment_ids is not None:
                raise ValueError("block_mask supports the scaled no-mask "
                                 "non-decode path without segment_ids")
            if (self.causal != block_mask.causal or self.window is not None
                    or self.global_prefix):
                raise ValueError(
                    "block_mask pattern conflicts with the layer: set "
                    "causal on the mask (and window/global_prefix only "
                    "on the mask)")
            if self.dropout_rate > 0.0 and not deterministic:
                raise ValueError(
                    "block_mask cannot apply attention-probability "
                    "dropout (no N² probs exist to drop) — set "
                    "dropout_rate=0.0")
        if self.global_prefix:
            if self.window is None:
                raise ValueError("global_prefix (attention sinks) is an escape "
                                 "from a sliding window — set window too")
            if self.use_flash:
                raise ValueError("the flash window kernel has no sink escape — "
                                 "express global_prefix via block_mask instead")
        if decode and not self.causal:
            raise ValueError("decode=True requires causal=True")
        if decode and self.max_decode_len is None and self.window is None:
            raise ValueError("decode=True requires max_decode_len (or a "
                             "sliding window for the ring-buffer cache)")
        if self.kv_cache_dtype not in (None, "int8"):
            raise ValueError("kv_cache_dtype must be None or 'int8', got "
                             f"{self.kv_cache_dtype!r}")
        if self.kv_page_size is not None:
            if self.kv_page_size < 1:
                raise ValueError("kv_page_size must be >= 1")
            if self.kv_num_pages is not None and self.kv_num_pages < 1:
                raise ValueError("kv_num_pages must be >= 1")
            if self.window is not None:
                raise ValueError("paged caches do not compose with ring caches "
                                 "(window) — pick one layout")
            if self.max_decode_len is None:
                raise ValueError("kv_page_size requires max_decode_len")
        elif self.kv_num_pages is not None:
            raise ValueError("kv_num_pages requires kv_page_size")
        if decode and not scaled:
            raise ValueError("decode supports the scaled no-mask path")
        if decode and segment_ids is not None:
            raise ValueError("decode does not support segment_ids")
        if self.rope and not scaled:
            raise ValueError("rope requires the scaled no-mask path")
        if self.logit_softcap is not None:
            if self.logit_softcap <= 0.0:
                raise ValueError("logit_softcap must be positive, got "
                                 f"{self.logit_softcap}")
            if not scaled:
                raise ValueError("logit_softcap requires the scaled no-mask path")
            if block_mask is not None:
                raise ValueError("the block-sparse kernel has no logit_softcap")
        if prompt_lengths is not None:
            if not decode:
                raise ValueError("prompt_lengths is a decode-prefill argument")
            if self.window is not None:
                raise ValueError("ragged prefill is not supported on ring "
                                 "caches (per-sequence ring layouts diverge) "
                                 "— pad to equal lengths")

    def forward(self, inputs, deterministic: bool = True, decode: bool = False,
                segment_ids=None, block_mask=None, prompt_lengths=None,
                cache: Optional[dict] = None, scope: str = ""):
        """Attention over ``inputs = [Q, K, V(, M)]``, each (B, N, d).

        Returns (B, N, d_output); with ``decode=True``, ``(y, cache)``, the
        cache dict updated in place (created when ``cache`` is None or
        lacks this layer's entries). ``scope`` is the layer's path in the
        cache, as in ``ku``'s collection (``block0/MultiHeadAttention_1``)."""
        self._validate(decode, segment_ids, block_mask, prompt_lengths,
                       deterministic)
        q, k, v = inputs[0], inputs[1], inputs[2]
        m = inputs[3] if len(inputs) > 3 else None
        d_k, d_v = k.shape[-1], v.shape[-1]
        h = self.num_head
        hkv = self.num_kv_head if self.num_kv_head is not None else h
        d_k_h, d_v_h = d_k // h, d_v // h
        par = self.parallel if self.parallel is not None and self.parallel.world > 1 else None
        if par is not None:  # this rank's heads; W_multi_head closes with a sum
            h, hkv = h // par.world, hkv // par.world
            q, k, v = (copy_to(t, par.group) for t in (q, k, v))

        def split_heads(x, dh, nh=h):
            b, n = x.shape[0], x.shape[1]
            return x.reshape(b, n, nh, dh).transpose(1, 2)

        q_h = split_heads(self._project(q, "W_Q"), d_k_h)
        k_h = split_heads(self._project(k, "W_K"), d_k_h, hkv)
        v_h = split_heads(self._project(v, "W_V"), d_v_h, hkv)
        if self.rope:
            if d_k_h % 2:
                raise ValueError(f"rope needs an even head dim, got {d_k_h}")
            if not decode:
                # Positions 0..n-1 on both sides; decode rotates by global
                # cache positions instead.
                q_h = apply_rope(q_h, torch.arange(q_h.shape[2], device=q.device),
                                 self.rope_base)
                k_h = apply_rope(k_h, torch.arange(k_h.shape[2], device=k.device),
                                 self.rope_base)

        if decode:
            if cache is None:
                cache = {}
            head = self._decode(q_h, k_h, v_h, d_k, prompt_lengths, cache, scope)
        elif block_mask is not None:
            head = sparse_attention(q_h, k_h, v_h, block_mask,
                                    softmax_scale=1.0 / math.sqrt(d_k))
        elif (self.use_flash and self.similarity_type == SIMILARITY_TYPE_SCALED
              and not self.use_mask
              and (self.dropout_rate == 0.0 or deterministic)):
            head = flash_attention(q_h, k_h, v_h,
                                   softmax_scale=1.0 / math.sqrt(d_k),
                                   causal=self.causal, window=self.window,
                                   segment_ids=segment_ids,
                                   logit_softcap=self.logit_softcap)
        else:
            head = self._dense(q_h, k_h, v_h, m, d_k, segment_ids, deterministic)

        b, n = q.shape[0], q.shape[1]
        y = self._project(head.transpose(1, 2).reshape(b, n, h * d_v_h), "W_multi_head")
        if par is not None:
            y = reduce_sum(y, par.group)
        return (y, cache) if decode else y

    def _project(self, x, name):
        """``x @ W``, or with ``quant_weights`` the int8 weight and its
        column scales (:func:`ku_torch.nn.quant.quant_project`)."""
        w = getattr(self, name)
        if not self.quant_weights:
            return x @ w
        return quant_project(x, w, getattr(self, name + "_scale"),
                             self.quant_weights == "w8a8")

    def _dense(self, q_h, k_h, v_h, m, d_k, segment_ids, deterministic):
        h = q_h.shape[1]
        if k_h.shape[1] != h:  # GQA on the dense path: materialise the repeat
            k_h = k_h.repeat_interleave(h // k_h.shape[1], dim=1)
            v_h = v_h.repeat_interleave(h // v_h.shape[1], dim=1)
        st = self.similarity_type
        if st == SIMILARITY_TYPE_PLAIN:
            scores = torch.einsum("bhqd,bhkd->bhqk", q_h, k_h)
        elif st == SIMILARITY_TYPE_SCALED:
            # Scaled by sqrt(d_k), the full model width, as ku and its
            # reference do, not by the head width.
            scores = self._cap(torch.einsum("bhqd,bhkd->bhqk", q_h, k_h)
                               / math.sqrt(d_k))
        elif st == SIMILARITY_TYPE_GENERAL:
            scores = torch.einsum("bhqd,bhkd->bhqk", q_h, k_h @ self.W_gen_S)
        elif st == SIMILARITY_TYPE_DIFF_ABS:
            diff = (q_h[:, :, :, None, :] - k_h[:, :, None, :, :]).abs()
            scores = torch.exp(-diff.mean(dim=-1))
        else:  # additive
            qa = q_h @ self.W_add_S_Q
            ka = k_h @ self.W_add_S_K
            scores = torch.tanh(qa[:, :, :, None, :] + ka[:, :, None, :, :]
                                ).sum(dim=-1) / math.sqrt(q_h.shape[-1])
        if self.causal:
            nq, nk = scores.shape[-2], scores.shape[-1]
            q_pos = torch.arange(nq, device=scores.device)[:, None]
            k_pos = torch.arange(nk, device=scores.device)[None, :]
            keep = k_pos <= q_pos
            if self.window is not None:
                keep = keep & ((q_pos - k_pos < self.window)
                               | (k_pos < self.global_prefix))
            scores = torch.where(keep[None, None], scores, _MASKED)
        if segment_ids is not None:
            seg_q, seg_k = (segment_ids if isinstance(segment_ids, (tuple, list))
                            else (segment_ids, segment_ids))
            seg_q = torch.as_tensor(seg_q, device=scores.device)
            seg_k = torch.as_tensor(seg_k, device=scores.device)
            keep_seg = seg_q[:, :, None] == seg_k[:, None, :]
            scores = torch.where(keep_seg[:, None], scores, _MASKED)
        probs = torch.softmax(scores, dim=-1)
        if self.use_mask and m is not None:
            probs = probs * m
        if self.dropout_rate > 0.0 and not deterministic:
            probs = F.dropout(probs, p=self.dropout_rate, training=True)
        return torch.einsum("bhqk,bhkd->bhqd", probs, v_h)

    def _decode(self, q_h, k_h, v_h, d_k, prompt_lengths, cache, scope):
        """Cache decode: write this chunk's K/V at each row's index (the
        dense cache, or the pool through the row's table), then attend the
        cache. Returns the heads (B, H, L, Dv/H)."""
        bsz, h, L, d_k_h = q_h.shape
        hkv, d_v_h = k_h.shape[1], v_h.shape[-1]
        device, kv_dt = q_h.device, k_h.dtype
        paged, quant = self.kv_page_size is not None, self.kv_cache_dtype is not None
        ring = self.window is not None
        if paged:
            pg = self.kv_page_size
            mp = -(-self.max_decode_len // pg)
            n_pages = self.kv_num_pages if self.kv_num_pages is not None else bsz * mp
            mx = mp * pg
        elif ring:
            mx = self.global_prefix + self.window
        else:
            mx = self.max_decode_len
        has_cache = scoped(scope, "cached_key") in cache

        def entry(name, make):
            key = scoped(scope, name)
            if key not in cache:
                cache[key] = make()
            return cache[key]

        def zeros(*shape, dtype=torch.int8 if quant else kv_dt):
            return lambda: torch.zeros(shape, dtype=dtype, device=device)

        table = None
        if paged:
            if n_pages < bsz * mp and scoped(scope, "page_table") not in cache:
                warnings.warn(
                    f"paged cache: kv_num_pages={n_pages} < B*pages-per-seq="
                    f"{bsz * mp}, so the default identity page_table ALIASES "
                    "pool pages (clamped) — wrong attention unless a scheduler "
                    "(e.g. ku_torch.nn.ContinuousBatcher) overwrites the table "
                    "values before real use", stacklevel=4)
            ck = entry("pages_k", zeros(n_pages, hkv, d_k_h, pg))
            cv = entry("pages_v", zeros(n_pages, hkv, d_v_h, pg))
            table = entry("page_table", lambda: torch.minimum(
                torch.arange(bsz, device=device)[:, None] * mp
                + torch.arange(mp, device=device)[None], torch.tensor(
                    n_pages - 1, device=device)).to(torch.int32))
        elif ring:
            # The ring is slot-major (B, Hkv, slots, D): its bookkeeping
            # gathers along the slots, and no kernel reads it.
            ck = entry("cached_key", zeros(bsz, hkv, mx, d_k_h))
            cv = entry("cached_value", zeros(bsz, hkv, mx, d_v_h))
        else:
            ck = entry("cached_key", zeros(bsz, hkv, d_k_h, mx))
            cv = entry("cached_value", zeros(bsz, hkv, d_v_h, mx))
        idx = entry("cache_index", zeros(bsz, dtype=torch.int32))
        ksc = vsc = None
        if quant:
            shape = (n_pages, hkv, pg) if paged else (bsz, hkv, mx)
            suffix = "_pages" if paged else ""
            ksc = entry("key_scale" + suffix, zeros(*shape, dtype=torch.float32))
            vsc = entry("value_scale" + suffix, zeros(*shape, dtype=torch.float32))
        if prompt_lengths is not None:
            if L == 1:
                raise ValueError("prompt_lengths requires a chunk of width > 1 "
                                 "(per-token steps always advance each "
                                 "sequence by 1)")
            prompt_lengths = torch.as_tensor(prompt_lengths, device=device
                                             ).to(torch.int32)
            if prompt_lengths.shape != (bsz,):
                raise ValueError(f"prompt_lengths must have shape ({bsz},), "
                                 f"got {tuple(prompt_lengths.shape)}")
        steps = torch.arange(L, device=device)
        posn = idx[:, None] + steps[None]  # (B, L) global positions
        if self.rope:
            # Global positions, before quantising and caching: cached keys
            # never need rotating again.
            q_h = apply_rope(q_h, posn, self.rope_base)
            k_h = apply_rope(k_h, posn, self.rope_base)
        k_st, v_st = k_h, v_h
        k_s = v_s = None
        if quant:
            (k_st, k_s), (v_st, v_s) = _quantize(k_h), _quantize(v_h)
        if ring:
            cpos = entry("cache_pos", lambda: torch.full(
                (bsz, mx), -1, dtype=torch.int32, device=device))
            if quant:
                # Attention sees the dequantised values, as a per-token
                # step would read them back.
                k_h = (k_st.float() * k_s[..., None]).to(kv_dt)
                v_h = (v_st.float() * v_s[..., None]).to(kv_dt)
            if L > 1:
                if has_cache:
                    raise ValueError(
                        "ring-cache prefill requires an EMPTY cache (it "
                        "overwrites rather than merges) — chunked prefill is "
                        "dense-cache only")
                head = self._ring_prefill(q_h, k_h, v_h, d_k)
                self._ring_fill(L, mx, [(ck, k_st), (cv, v_st), (ksc, k_s),
                                        (vsc, v_s)], cpos)
            else:
                head = self._ring_step(q_h, k_st, v_st, k_s, v_s, d_k, idx, ck,
                                       cv, ksc, vsc, cpos)
            cache[scoped(scope, "cache_index")] = idx + L
            return head

        # The chunk arrives (B, Hkv, L, D); the cache is slot-minor.
        writes = [(ck, k_st.permute(0, 2, 1, 3)), (cv, v_st.permute(0, 2, 1, 3))]
        if quant:
            writes += [(ksc, k_s.permute(0, 2, 1)), (vsc, v_s.permute(0, 2, 1))]
        if paged:
            _write_pages(writes, table, posn, pg)
        else:
            # Per-row write at idx, start clamped so the chunk fits (as ku's
            # dynamic_update_slice).
            slots = idx.clamp(0, mx - L).long()[:, None] + steps[None]
            rows = torch.arange(bsz, device=device)[:, None]
            for dest, value in writes:
                dest[rows, ..., slots] = value
        cache[scoped(scope, "cache_index")] = idx + (
            prompt_lengths if prompt_lengths is not None else L)
        scale = 1.0 / math.sqrt(d_k)
        group = h // hkv
        qg = q_h.reshape(bsz, hkv, group, L, d_k_h)

        if L == 1 and self.flash_decode is not False:
            kw = dict(k_scale=ksc, v_scale=vsc, softmax_scale=scale,
                      logit_softcap=self.logit_softcap)
            q1 = qg[:, :, :, 0].contiguous()
            res = (decode_attention_paged(q1, ck, cv, table, idx + 1,
                                          pipelined="v4", **kw) if paged
                   else decode_attention(q1, ck, cv, idx + 1, **kw))
            return res.reshape(bsz, h, 1, d_v_h)
        if L == 1 and paged:
            return self._page_scan(qg, ck, cv, ksc, vsc, table, idx, scale,
                                   kv_dt).reshape(bsz, h, 1, d_v_h)

        pos = torch.arange(mx, device=device)[None, None, :]
        keep = pos <= posn[:, :, None]  # (B, L, mx)
        if L == 1 and quant:
            # ku's scale-folded int8 read: int8 cast to the K/V dtype in the
            # products, scales on the score and probability slabs.
            s = torch.einsum("bhgqd,bhdk->bhgqk", qg, ck.to(kv_dt)).float()
            s = self._cap(s * (ksc * scale)[:, :, None, None, :])
            s = torch.where(keep[:, None, None], s, _MASKED)
            p = torch.softmax(s, dim=-1)
            pv = (p * vsc[:, :, None, None, :]).to(kv_dt)
            return torch.einsum("bhgqk,bhdk->bhgqd", pv, cv.to(kv_dt)
                                ).reshape(bsz, h, 1, d_v_h)

        def full(pool, scales):
            """The whole (B, Hkv, D, mx) cache in the K/V dtype."""
            x = gather_pages(pool, table) if paged else pool
            if quant:
                sx = gather_pages(scales, table) if paged else scales
                x = (x.float() * sx[:, :, None, :]).to(kv_dt)
            return x

        kf, vf = full(ck, ksc), full(cv, vsc)
        # Attend the whole cache under a causal mask at q_offset = idx: it
        # admits earlier chunks' keys and hides the unwritten tail. Padding
        # past a row's prompt length is written but stays invisible below
        # cache_index, and its outputs are ignored.
        if L > 1 and self.use_flash:
            return flash_attention(q_h, kf.transpose(2, 3), vf.transpose(2, 3),
                                   softmax_scale=scale, causal=True,
                                   q_offset=idx, logit_softcap=self.logit_softcap)
        s = torch.einsum("bhgqd,bhdk->bhgqk", qg, kf) / math.sqrt(d_k)
        s = torch.where(keep[:, None, None], self._cap(s), _MASKED)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhgqk,bhdk->bhgqd", p, vf).reshape(bsz, h, L, d_v_h)

    def _ring_prefill(self, q_h, k_h, v_h, d_k):
        """The ring's prompt pass over the raw prompt (a window neighbour may
        sit in a slot that a later prompt token overwrites): banded flash
        attention with ``use_flash`` (no sinks then), else the dense masked
        pass with the sinks' escape."""
        bsz, h, L, d_k_h = q_h.shape
        hkv, d_v_h = k_h.shape[1], v_h.shape[-1]
        gp, win = self.global_prefix, self.window
        if self.use_flash:
            return flash_attention(q_h, k_h, v_h, softmax_scale=1.0 / math.sqrt(d_k),
                                   causal=True, window=win,
                                   logit_softcap=self.logit_softcap)
        pos = torch.arange(L, device=q_h.device)
        q_pos, k_pos = pos[:, None], pos[None, :]
        keep = (k_pos <= q_pos) & ((q_pos - k_pos < win) | (k_pos < gp))
        qg = q_h.reshape(bsz, hkv, h // hkv, L, d_k_h)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_h) / math.sqrt(d_k)
        s = torch.where(keep, self._cap(s), _MASKED)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhgqk,bhkd->bhgqd", p, v_h).reshape(bsz, h, L, d_v_h)

    def _ring_fill(self, L, mx, writes, cpos):
        """After a prefill of L tokens into an empty ring: each slot takes the
        last prompt position written to it (sink slot s holds position s,
        ring slot s the largest gp + (s − gp) + k·window below L), and
        ``cache_pos`` records it; slots no position reached stay empty."""
        gp, win = self.global_prefix, self.window
        sl = torch.arange(mx, device=cpos.device)
        r = sl - gp
        last = torch.where(sl < gp, sl, gp + r + ((L - 1 - gp - r) // win) * win)
        valid = torch.where(sl < gp, sl < L, last >= gp)
        src = last.clamp(0, L - 1)
        for dest, value in writes:
            if dest is None:
                continue
            picked = value.index_select(2, src)  # (B, Hkv, mx(, D))
            keep = valid.view((1, 1, mx) + (1,) * (picked.dim() - 3))
            dest.copy_(torch.where(keep, picked, dest))
        cpos.copy_(torch.where(valid[None], last.to(torch.int32)[None], cpos))

    def _ring_step(self, q_h, k_st, v_st, k_s, v_s, d_k, idx, ck, cv, ksc, vsc, cpos):
        """One token a row into the ring: write its slot (a sink below
        ``global_prefix``, else gp + (idx − gp) mod window), record its
        position, and attend the occupied slots whose positions are sinks or
        inside the window. Plain torch on every device: ku reads the ring
        with XLA, never with its decode kernel."""
        bsz, h, _, d_k_h = q_h.shape
        hkv, d_v_h = ck.shape[1], cv.shape[-1]
        gp, win = self.global_prefix, self.window
        rows = torch.arange(bsz, device=idx.device)
        slot = torch.where(idx < gp, idx, gp + (idx - gp).remainder(win)).long()
        cpos[rows, slot] = idx
        ck[rows, :, slot] = k_st[:, :, 0]
        cv[rows, :, slot] = v_st[:, :, 0]
        if ksc is not None:
            ksc[rows, :, slot] = k_s[:, :, 0]
            vsc[rows, :, slot] = v_s[:, :, 0]
        keep = (cpos >= 0) & ((cpos < gp) | (idx[:, None] - cpos < win))
        keep = keep[:, None, None, None, :]
        qg = q_h.reshape(bsz, hkv, h // hkv, 1, d_k_h)
        kv_dt = q_h.dtype
        if ksc is not None:
            # ku's scale-folded int8 read: the int8 cast to the K/V dtype in
            # the products, the scales on the score and probability slabs.
            s = torch.einsum("bhgqd,bhkd->bhgqk", qg, ck.to(kv_dt)).float()
            s = self._cap(s * (ksc * (1.0 / math.sqrt(d_k)))[:, :, None, None, :])
            p = torch.softmax(torch.where(keep, s, _MASKED), dim=-1)
            pv = (p * vsc[:, :, None, None, :]).to(kv_dt)
            head = torch.einsum("bhgqk,bhkd->bhgqd", pv, cv.to(kv_dt))
        else:
            s = torch.einsum("bhgqd,bhkd->bhgqk", qg, ck) / math.sqrt(d_k)
            p = torch.softmax(torch.where(keep, self._cap(s), _MASKED), dim=-1)
            head = torch.einsum("bhgqk,bhkd->bhgqd", p, cv)
        return head.reshape(bsz, h, 1, d_v_h)

    def _page_scan(self, qg, ck, cv, ksc, vsc, table, idx, scale, kv_dt):
        """ku's plain per-token read of a pool (its blocked page scan): f32
        scores and accumulators, int8 scales folded into the score and
        probability slabs, the probabilities not rounded; here over the
        gathered view at once instead of 8 pages a step."""
        if ksc is not None:
            s = torch.einsum("bhgqd,bhdk->bhgqk", qg,
                             gather_pages(ck, table).to(kv_dt)).float()
            s = s * gather_pages(ksc, table)[:, :, None, None, :] * scale
        else:
            s = torch.einsum("bhgqd,bhdk->bhgqk", qg.float(),
                             gather_pages(ck, table).float()) * scale
        s = self._cap(s)
        live = torch.arange(s.shape[-1], device=s.device)[None] <= idx[:, None]
        s = torch.where(live[:, None, None, None], s, _MASKED)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        if vsc is not None:
            p = p * gather_pages(vsc, table)[:, :, None, None, :]
        vf = torch.where(live[:, None, None], gather_pages(cv, table).float(), 0.0)
        acc = torch.einsum("bhgqk,bhdk->bhgqd", p, vf)
        return (acc / l).to(qg.dtype)


def _quantize(x):
    """Symmetric per-(token, head) int8: the largest |element| of each
    vector maps to 127. Returns (int8 values, f32 scales), as ku's
    ``_quant``, the scale computed in x's dtype, divided by a tensor so
    that the card rounds the quotient as the CPU does (``_127``)."""
    amax = x.abs().amax(dim=-1)
    s = (amax / _127(amax)).clamp_min(1e-12)
    q = torch.round(x / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s.float()


def _write_pages(writes, table, posn, pg):
    """``dest[table[b, pos // pg], ..., pos % pg] = value[b, l]`` for every
    (dest pool, value (B, L, ...)) pair, row b and global position pos =
    posn[b, l]. A position past the table's end is dropped, as ku's table
    scatter drops it. A per-token step drops it without a host sync by
    writing back what was there; a prefill selects the kept positions."""
    mp = table.shape[1]
    page = posn // pg
    keep = page < mp
    pid = table.gather(1, page.clamp(0, mp - 1)).long()
    off = posn % pg
    if posn.shape[1] == 1:
        for dest, value in writes:
            old = dest[pid, ..., off]
            dest[pid, ..., off] = torch.where(
                keep.view(keep.shape + (1,) * (value.dim() - 2)), value, old)
        return
    sel = keep.nonzero(as_tuple=True)
    for dest, value in writes:
        dest[pid[sel], ..., off[sel]] = value[sel]
