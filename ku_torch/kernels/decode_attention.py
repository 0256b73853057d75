"""Flash-decoding over a dense KV cache, as one CUDA kernel, with its plain
version.

Port of ``ku/pallas/decode_attention.py`` (dense part). The kernel,
``ku_torch/csrc/decode_attention.cu``, replaces
``ku/pallas/decode_attention.py::_kernel``: one block per (row, KV head)
reads the row's live cache prefix once and folds it into an online softmax
for the G query heads of that KV head. Its source note says what bounds it
on an H100 (bytes; at the serving shapes, its launch latency) and what the
design does about that.

- :func:`decode_attention_cuda` launches the kernel. It takes CUDA tensors
  only and adds one to ``decode_attention_cuda.launches`` per launch.
- :func:`decode_attention_torch` is the plain version: the same function in
  torch ops, on tensors of any device.
- :func:`decode_attention` picks by the device of ``q``: the kernel for a
  CUDA tensor, the plain version for a CPU tensor. It never falls back from
  one to the other.

Contract, as ``ku.pallas.decode_attention.decode_attention``: ``q`` is
(B, Hkv, G, D), the cache ``k``/``v`` is (B, Hkv, D, S)/(B, Hkv, Dv, S) with
the slot axis minor, ``lengths`` (B,) int32 counts each row's live slots
(values above S read all S), and int8 caches come with (B, Hkv, S) f32
``k_scale``/``v_scale``. The result is (B, Hkv, G, Dv) in ``q``'s dtype,
accumulated in f32, with the probabilities rounded to ``q``'s dtype before
the PV product; a row of length <= 0 gets 0. ``softmax_scale`` defaults to
1/sqrt(D). On the card G is at most 16 and Dv at most 128.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional

import torch

from ku_torch.kernels import _build

NAME = "decode_attention"
SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "decode_attention.cu"
_MASKED = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build(SOURCE, NAME)[0]))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention_launch.argtypes = [p] * 7 + [i] * 6 + [f, f, i, i, p]
    lib.decode_attention_launch.restype = i
    lib.decode_attention_error_string.argtypes = [i]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, lengths, k_scale, v_scale):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("decode_attention takes q (B, Hkv, G, D) and a cache "
                         "(B, Hkv, D, S)")
    bsz, hkv, _, d = q.shape
    s = k.shape[3]
    if k.shape[:3] != (bsz, hkv, d) or v.shape[:2] != (bsz, hkv) \
            or v.shape[3] != s:
        raise ValueError(f"cache shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if lengths.shape != (bsz,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({bsz},)")
    quant = k_scale is not None
    if quant != (v_scale is not None) or quant != (k.dtype == torch.int8) \
            or k.dtype != v.dtype:
        raise ValueError("int8 caches take k_scale and v_scale; others neither")
    if quant and (k_scale.shape != (bsz, hkv, s) or v_scale.shape != (bsz, hkv, s)):
        raise ValueError(f"scales must be ({bsz}, {hkv}, {s})")
    if not quant and k.dtype != q.dtype:
        raise ValueError(f"cache dtype {k.dtype} != query dtype {q.dtype}")


def decode_attention_cuda(q, k, v, lengths, *, k_scale=None, v_scale=None,
                          softmax_scale: Optional[float] = None,
                          logit_softcap: Optional[float] = None):
    """Single-token attention over the cache as one launch of the kernel.

    Takes contiguous CUDA tensors on one device: q f32 or bf16, the cache in
    q's dtype or int8 with f32 scales, lengths int32. Launches on the
    current stream and does not synchronise. Raises on anything else and
    if the launch is refused."""
    _check(q, k, v, lengths, k_scale, v_scale)
    tensors = [q, k, v, lengths] + ([k_scale, v_scale] if k_scale is not None
                                    else [])
    device = q.device
    for t in tensors:
        if t.device != device or device.type != "cuda":
            raise ValueError("decode_attention_cuda takes CUDA tensors on one "
                             f"device, got {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError("decode_attention_cuda takes contiguous tensors")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_attention_cuda takes f32 or bf16 queries, "
                         f"got {q.dtype}")
    if lengths.dtype != torch.int32:
        raise ValueError("lengths must be int32")
    if k_scale is not None and (k_scale.dtype != torch.float32
                                or v_scale.dtype != torch.float32):
        raise ValueError("k_scale and v_scale must be float32")
    bsz, hkv, g, d = q.shape
    dv, s = v.shape[2], k.shape[3]
    if g > 16 or dv > 128:
        raise ValueError("decode_attention_cuda takes up to 16 query heads per "
                         f"KV head and value heads up to 128 wide, got {g}, {dv}")
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    out = torch.empty(bsz, hkv, g, dv, dtype=q.dtype, device=device)
    lib = _library()
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        out.data_ptr(), bsz, hkv, g, d, dv, s, float(softmax_scale),
        float(logit_softcap or 0.0), _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[k.dtype], torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("decode_attention launch failed: "
                           f"{lib.decode_attention_error_string(err).decode()} "
                           f"({err})")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0


def decode_attention_torch(q, k, v, lengths, *, k_scale=None, v_scale=None,
                           softmax_scale: Optional[float] = None,
                           logit_softcap: Optional[float] = None):
    """The plain version of :func:`decode_attention_cuda`, on any device:
    the same scores, masks and roundings, the softmax taken over all S slots
    at once instead of tile by tile."""
    _check(q, k, v, lengths, k_scale, v_scale)
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhgd,bhds->bhgs", q.float(), k.to(q.dtype).float())
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    s = s * softmax_scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    slot = torch.arange(k.shape[3], device=q.device)
    live = slot[None, :] < lengths.to(q.device)[:, None].long()
    s = torch.where(live[:, None, None, :], s, _MASKED)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
    p = p.to(q.dtype).float()
    o = torch.einsum("bhgs,bhds->bhgd", p, v.to(q.dtype).float()) / l
    o = torch.where(live.any(dim=-1)[:, None, None, None], o, 0.0)
    return o.to(q.dtype)


def decode_attention(q, k, v, lengths, *, k_scale=None, v_scale=None,
                     softmax_scale: Optional[float] = None,
                     logit_softcap: Optional[float] = None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    kw = dict(k_scale=k_scale, v_scale=v_scale, softmax_scale=softmax_scale,
              logit_softcap=logit_softcap)
    if q.device.type == "cuda":
        return decode_attention_cuda(q, k, v, lengths, **kw)
    if q.device.type == "cpu":
        return decode_attention_torch(q, k, v, lengths, **kw)
    raise ValueError(f"no decode attention for device {q.device}")
