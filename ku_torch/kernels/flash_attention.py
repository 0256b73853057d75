"""Flash-attention forward as one CUDA kernel, with its plain version.

Port of ``ku/pallas/flash_attention.py`` (forward part). The kernel,
``ku_torch/csrc/flash_fwd.cu``, replaces
``ku/pallas/flash_attention.py::_fwd_kernel``: one block per (batch·head,
64-query tile) streams the live 64-key tiles through shared memory into an
online softmax and writes the output and the f32 log-sum-exp. Its source
note says what bounds it on an H100 and what the design does about that.
The backward kernels (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) are not
ported yet, so nothing here is differentiable on the card.

- :func:`flash_fwd_cuda` launches the kernel. It takes CUDA tensors only and
  adds one to ``flash_fwd_cuda.launches`` per launch.
- :func:`flash_fwd_torch` is the plain version: the same function in torch
  ops, on tensors of any device.
- :func:`flash_fwd` picks by the device of ``q``: the kernel for a CUDA
  tensor, the plain version for a CPU tensor, never one for the other.
- :func:`flash_attention` is what ``MultiHeadAttention(use_flash=True)``
  calls: :func:`flash_fwd`'s output, refusing a call that needs gradients.

Contract, as ``ku.pallas.flash_attention._fwd_pallas``: q (B, H, N, D),
k/v (B, Hkv, KN, D)/(B, Hkv, KN, Dv) with H a multiple of Hkv (query head j
reads KV head j // (H/Hkv)); ``causal`` and ``window`` (requires causal);
``segment_ids`` a (B, N) int array or a (seg_q, seg_k) pair; scalar or
per-row (B,) ``q_offset``/``k_offset`` global positions for the masks;
``logit_softcap``; any N and KN; Dv up to 128 on the card. Returns
(o (B, H, N, Dv) in q's dtype, lse (B, H, N) f32). A query row that no key
may attend (all masked) gets o = 0 and lse = -1e30.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from ku_torch.kernels import _build

NAME = "flash_fwd"
SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "flash_fwd.cu"
_MASKED = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build(SOURCE, NAME)[0]))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.flash_fwd_launch.argtypes = ([p] * 9 + [i] * 7 + [ll] * 12
                                     + [f, f, i, i, i, p])
    lib.flash_fwd_launch.restype = i
    lib.flash_fwd_error_string.argtypes = [i]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _norm_segments(segment_ids, b, n, kn, device):
    """(seg_q (B, N), seg_k (B, KN)) int32 tensors, or None; one (B, N)
    array serves both sides (self-attention)."""
    if segment_ids is None:
        return None
    if isinstance(segment_ids, (tuple, list)):
        seg_q, seg_k = segment_ids
    else:
        seg_q = seg_k = segment_ids
    seg_q = torch.as_tensor(seg_q, device=device).to(torch.int32)
    seg_k = torch.as_tensor(seg_k, device=device).to(torch.int32)
    if seg_q.shape != (b, n) or seg_k.shape != (b, kn):
        raise ValueError(f"segment_ids shapes {tuple(seg_q.shape)}/"
                         f"{tuple(seg_k.shape)} != ({b}, {n})/({b}, {kn})")
    return seg_q.contiguous(), seg_k.contiguous()


def _offsets(offset, b, device):
    """A scalar or (B,) offset → a (B,) int32 tensor on ``device``."""
    if offset is None:
        return torch.zeros(b, dtype=torch.int32, device=device)
    t = torch.as_tensor(offset, device=device).to(torch.int32)
    if t.dim() > 1 or (t.dim() == 1 and t.shape[0] not in (1, b)):
        raise ValueError(f"offset shape {tuple(t.shape)} is neither scalar "
                         f"nor ({b},)")
    return t.reshape(-1).expand(b).contiguous()


def _check(q, k, v, causal, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes (B, H, N, D) tensors")
    b, h, _, d = q.shape
    hkv = k.shape[1]
    if v.shape[1] != hkv:
        raise ValueError(f"k has {hkv} heads but v has {v.shape[1]}")
    if h % hkv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({hkv})")
    if k.shape[0] != b or v.shape[0] != b or k.shape[3] != d \
            or v.shape[2] != k.shape[2]:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not fit")
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_fwd_cuda(q, k, v, *, softmax_scale: float = 1.0, causal: bool = False,
                   window: Optional[int] = None, segment_ids=None,
                   q_offset=None, k_offset=None,
                   logit_softcap: Optional[float] = None):
    """The forward as one launch of the kernel: (o, lse).

    Takes CUDA tensors on one device, q/k/v all f32 or all bf16 with any
    strides. Launches on the current stream and does not synchronise.
    Raises on anything else and if the launch is refused."""
    _check(q, k, v, causal, window)
    device = q.device
    for t in (q, k, v):
        if t.device != device or device.type != "cuda":
            raise ValueError("flash_fwd_cuda takes CUDA tensors on one device, "
                             f"got {t.device} and {device}")
        if t.dtype != q.dtype or q.dtype not in _DTYPE_CODES:
            raise ValueError("flash_fwd_cuda takes q, k, v all float32 or all "
                             f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, n, d = q.shape
    hkv, kn, dv = k.shape[1], k.shape[2], v.shape[3]
    if dv > 128:
        raise ValueError(f"flash_fwd_cuda takes value heads up to 128 wide, got {dv}")
    segs = _norm_segments(segment_ids, b, n, kn, device)
    q_off, k_off = _offsets(q_offset, b, device), _offsets(k_offset, b, device)
    o = torch.empty(b, h, n, dv, dtype=q.dtype, device=device)
    lse = torch.empty(b, h, n, dtype=torch.float32, device=device)
    lib = _library()
    err = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        q_off.data_ptr(), k_off.data_ptr(),
        segs[0].data_ptr() if segs else None,
        segs[1].data_ptr() if segs else None,
        b, h, hkv, n, kn, d, dv, *q.stride(), *k.stride(), *v.stride(),
        float(softmax_scale), float(logit_softcap or 0.0), int(causal),
        int(window or 0), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_fwd launch failed: "
                           f"{lib.flash_fwd_error_string(err).decode()} ({err})")
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def flash_fwd_torch(q, k, v, *, softmax_scale: float = 1.0,
                    causal: bool = False, window: Optional[int] = None,
                    segment_ids=None, q_offset=None, k_offset=None,
                    logit_softcap: Optional[float] = None):
    """The plain version of :func:`flash_fwd_cuda`, on any device: the same
    scores, masks and roundings over the whole score matrix at once."""
    _check(q, k, v, causal, window)
    b, h, n, _ = q.shape
    hkv, kn = k.shape[1], k.shape[2]
    device = q.device
    segs = _norm_segments(segment_ids, b, n, kn, device)
    q_pos = _offsets(q_offset, b, device).long()[:, None] + torch.arange(n, device=device)
    k_pos = _offsets(k_offset, b, device).long()[:, None] + torch.arange(kn, device=device)
    kk = k.repeat_interleave(h // hkv, dim=1)
    vv = v.repeat_interleave(h // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * softmax_scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    keep = torch.ones(b, n, kn, dtype=torch.bool, device=device)
    if causal:
        keep &= k_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        keep &= q_pos[:, :, None] - k_pos[:, None, :] < window
    if segs is not None:
        keep &= segs[0][:, :, None] == segs[1][:, None, :]
    s = torch.where(keep[:, None], s, _MASKED)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vv.float())
    o = o / l[..., None]
    none = ~keep.any(dim=-1)[:, None]  # rows with no live key
    o = torch.where(none[..., None], 0.0, o)
    lse = torch.where(none, _MASKED, m[..., 0] + torch.log(l))
    return o.to(q.dtype), lse


def flash_fwd(q, k, v, **kw):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, **kw)
    if q.device.type == "cpu":
        return flash_fwd_torch(q, k, v, **kw)
    raise ValueError(f"no flash attention for device {q.device}")


def flash_attention(q, k, v, **kw):
    """Flash attention's output (:func:`flash_fwd`) for the forward-only
    paths: serving, and ``MultiHeadAttention(use_flash=True)`` outside
    training. Raises ``NotImplementedError`` when gradients are wanted: the
    backward kernels come with the training slice of the port."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "gradients through use_flash attention need the flash backward "
            "kernels (ku/pallas/flash_attention.py::_bwd_dq_kernel, "
            "_bwd_dkv_kernel), which come with the training slice of the "
            "port; run under torch.no_grad() or use use_flash=False")
    return flash_fwd(q, k, v, **kw)[0]
