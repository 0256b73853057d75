"""Flash attention, forward and backward, as CUDA kernels with their plain
versions, and the autograd function that joins them.

Port of ``ku/pallas/flash_attention.py``. Two sources, each with two
routes that the C entry picks (``route`` on each wrapper names the last
launch's, as the C entry reports it):

- ``ku_torch/csrc/flash_fwd.cu`` replaces ``_fwd_kernel``: one block per
  (batch·head, 64-query tile) streams the live 64-key tiles into an online
  softmax and writes the output and the f32 log-sum-exp.
- ``ku_torch/csrc/flash_bwd.cu`` replaces ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``: dq from one block per (batch·head, 64-query tile),
  dk and dv from one block per (batch·KV head, 64-key tile) that sums every
  query head of its group, both recomputing the probabilities from the
  saved log-sum-exp.
- Routes: bf16 with D and Dv up to 128 runs on the tensor cores (``"mma"``:
  warpgroup ``wgmma`` over bf16 tiles, f32 sums); f32, and a bf16 forward
  with D past 128, on the CUDA cores (``"f32"``). Nothing falls back from
  one to the other. Their source notes say what bounds them on an H100.

Functions:

- :func:`flash_fwd_cuda`, :func:`flash_bwd_dq_cuda` and
  :func:`flash_bwd_dkv_cuda` launch the kernels. They take CUDA tensors only
  and add one to their ``launches`` count per launch.
- :func:`flash_fwd_torch`, :func:`flash_bwd_dq_torch` and
  :func:`flash_bwd_dkv_torch` are the plain versions: the same functions in
  torch ops over the whole score matrix, on tensors of any device. The
  backward ones are the backward formula written out, not autograd over
  the forward.
- :func:`flash_bwd_cuda` / :func:`flash_bwd_torch` take the forward's o and
  lse and the output's gradient, form delta = rowsum(dO·O) in f32 (a torch
  op, as ``ku`` forms it in XLA outside its kernels) and return
  (dq, dk, dv).
- :func:`flash_fwd` and :func:`flash_bwd` pick by the device of ``q``: the
  kernels for a CUDA tensor, the plain versions for a CPU tensor, never one
  for the other.
- :func:`flash_attention` is what ``MultiHeadAttention(use_flash=True)``
  calls. When gradients are wanted it goes through :class:`FlashAttention`,
  whose forward is :func:`flash_fwd` and whose backward is :func:`flash_bwd`
  over the saved q, k, v, o and lse (``ku``'s ``jax.custom_vjp``); under
  ``torch.no_grad()`` it is :func:`flash_fwd`'s output alone.
- :func:`flash_layout` says how a tensor-core launch reads its tensors.
- :func:`ring_attention` is ``ku``'s sequence-parallel attention over a
  mesh dimension: one launch of the forward kernel a hop, at the global
  offsets of the rank's queries and of the visiting key block, merged by
  log-sum-exp, and a second ring pass of the backward kernels; or
  ``impl="xla"``, ``ku``'s plain online-softmax update.
  :func:`ring_attention_emulated` runs W ranks of it in one process.

Contract, as ``ku.pallas.flash_attention._fwd_pallas``: q (B, H, N, D),
k/v (B, Hkv, KN, D)/(B, Hkv, KN, Dv) with H a multiple of Hkv (query head j
reads KV head j // (H/Hkv)); ``causal`` and ``window`` (requires causal);
``segment_ids`` a (B, N) int array or a (seg_q, seg_k) pair; scalar or
per-row (B,) ``q_offset``/``k_offset`` global positions for the masks;
``logit_softcap``; any N and KN; on the card f32 or bf16, any strides, Dv up
to 128 (and D up to 128 for the backward). The forward returns (o (B, H, N,
Dv) in q's dtype, lse (B, H, N) f32); the backward (dq, dk, dv) in the
dtypes of q, k, v. A query row that no key may attend (all masked) gets
o = 0 and lse = -1e30, and its probabilities are 0 in the backward: dq = 0
for it, and it adds nothing to dk or dv. The segment ids and offsets get no
gradient.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ku_torch.kernels import _build

NAME = "flash_fwd"
SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "flash_fwd.cu"
BWD_NAME = "flash_bwd"
BWD_SOURCE = SOURCE.with_name("flash_bwd.cu")
_MASKED = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build(SOURCE, NAME)[0]))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.flash_fwd_launch.argtypes = ([p] * 9 + [i] * 7 + [ll] * 12
                                     + [f, f, i, i, i, p])
    lib.flash_fwd_launch.restype = i
    lib.flash_fwd_last_launch.argtypes = []
    lib.flash_fwd_last_launch.restype = i
    lib.flash_fwd_error_string.argtypes = [i]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build(BWD_SOURCE, BWD_NAME)[0]))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.flash_bwd_dq_launch, lib.flash_bwd_dkv_launch):
        fn.argtypes = [p] * 12 + [i] * 7 + [p, f, f, i, i, i, p]
        fn.restype = i
    lib.flash_bwd_last_launch.argtypes = []
    lib.flash_bwd_last_launch.restype = i
    lib.flash_bwd_error_string.argtypes = [i]
    lib.flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _runs_ready(t, unit: int) -> bool:
    """Whether the tensor-core kernels can copy ``t`` 16 bytes at a time
    along axis ``unit``: unit stride there, every other stride of an axis
    longer than 1 a multiple of 8 elements (16 bytes of bf16), and a
    16-byte-aligned start (``runs_aligned`` in ``attn_mma.cuh``)."""
    unit %= t.dim()
    return (t.stride(unit) == 1 and t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for i, (st, n) in enumerate(zip(t.stride(), t.shape))
                    if i != unit and n > 1))


def _mma_ready(t) -> bool:
    """Whether the tensor-core kernels can read ``t`` in rows along its last
    axis (:func:`_runs_ready`). Autograd's dO, a transposed view with rows
    H·Dv apart, can."""
    return _runs_ready(t, -1)


def _keys_ready(t) -> bool:
    """Whether the tensor-core forward can read a (B, Hkv, KN, D) ``t`` in
    place along its keys (:func:`_runs_ready` along axis 2). The serving
    prefill's transposed view of the slot-minor (B, Hkv, D, S) cache can,
    for S a multiple of 8."""
    return t.dim() == 4 and _runs_ready(t, 2)


def _mma_rows(t):
    """``t`` itself when :func:`_mma_ready`, else a copy whose rows are padded
    to a multiple of 8 elements (contiguous when the width is one), viewed
    at ``t``'s width."""
    if _mma_ready(t):
        return t
    width = t.shape[-1]
    out = torch.empty(*t.shape[:-1], -(-width // 8) * 8, dtype=t.dtype, device=t.device)
    out = out[..., :width]
    out.copy_(t)
    return out


def flash_route(dtype, d: int) -> str:
    """The kernels a launch of head width ``d`` takes, as the flash and the
    block-sparse C entries dispatch: bf16 up to 128 wide on the tensor cores
    (``"mma"``), f32 and a wider bf16 forward on the CUDA cores
    (``"f32"``). The wrappers copy for the tensor cores by it
    (:func:`_for_mma`); their ``route`` is what the C entry reports."""
    return "mma" if dtype == torch.bfloat16 and d <= 128 else "f32"


def flash_layout(q, k, v, do=None) -> str:
    """How a tensor-core launch reads q, k, v (and the backward's dO), from
    their shapes, strides and start addresses alone, as the C entries
    decide it:

    - ``"a"``: every tensor is :func:`_mma_ready`, rows unit-stride along
      the head (the training path: ``split_heads``' views, autograd's dO);
    - ``"b"``: the forward only (``do`` None), q is :func:`_mma_ready` and k
      and v are both :func:`_keys_ready`: the slot-minor cache, read in
      place by the tensor cores with no copy;
    - ``"c"``: anything else. The wrapper first copies each tensor that is
      not :func:`_mma_ready` into one that is (:func:`_mma_rows`), which the
      kernels then read as in ``"a"``: a copy on the card, not the plain
      version."""
    ready = [_mma_ready(t) for t in (q, k, v) + (() if do is None else (do,))]
    if all(ready):
        return "a"
    if do is None and ready[0] and _keys_ready(k) and _keys_ready(v):
        return "b"
    return "c"


# flash_fwd_last_launch's codes: (route, layout).
_FWD_LAUNCHED = {0: ("f32", None), 1: ("mma", "a"), 2: ("mma", "b")}


def _for_mma(entry, *tensors):
    """The tensors as a tensor-core launch reads them (:func:`flash_layout`):
    unchanged in layouts "a" and "b"; in "c" each one that is not
    :func:`_mma_ready` copied, and counted in ``entry.copies``."""
    layout = flash_layout(*tensors)
    if layout == "c":
        entry.copies += sum(not _mma_ready(t) for t in tensors)
        tensors = tuple(_mma_rows(t) for t in tensors)
    return layout, tensors


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


def _check_cuda(name, *tensors):
    """The kernels' common terms: CUDA tensors on one device, all f32 or
    all bf16; never a tracer's fake tensors."""
    _build.refuse_tracing(name, *tensors)
    device, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != device or device.type != "cuda":
            raise ValueError(f"{name} takes CUDA tensors on one device, "
                             f"got {t.device} and {device}")
        if t.dtype != dtype or dtype not in _DTYPE_CODES:
            raise ValueError(f"{name} takes q, k, v (and dO) all float32 or all "
                             f"bfloat16, got {[str(x.dtype) for x in tensors]}")


def _wide(x):
    """x in f32 for the sums (f64 stays f64, for gradcheck on the CPU)."""
    return x if x.dtype == torch.float64 else x.float()


def _keep(b, n, kn, causal, window, segs, q_offset, k_offset, device):
    """(B, N, KN) bool: which (query, key) pairs the masks leave live."""
    q_pos = _offsets(q_offset, b, device).long()[:, None] + torch.arange(n, device=device)
    k_pos = _offsets(k_offset, b, device).long()[:, None] + torch.arange(kn, device=device)
    keep = torch.ones(b, n, kn, dtype=torch.bool, device=device)
    if causal:
        keep &= k_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        keep &= q_pos[:, :, None] - k_pos[:, None, :] < window
    if segs is not None:
        keep &= segs[0][:, :, None] == segs[1][:, None, :]
    return keep


def flash_fwd_cuda(q, k, v, *, softmax_scale: float = 1.0, causal: bool = False,
                   window: Optional[int] = None, segment_ids=None,
                   q_offset=None, k_offset=None,
                   logit_softcap: Optional[float] = None):
    """The forward as one launch of the kernel: (o, lse).

    Takes CUDA tensors on one device, q/k/v all f32 or all bf16 with any
    strides. bf16 with D and Dv up to 128 runs on the tensor cores, f32 and
    a wider bf16 head on the CUDA cores (``launches`` counts both;
    ``route`` names the last one's and ``layout`` its layout on the tensor
    cores, as the C entry reports them, "c" where the wrapper copied). The tensor-core kernel reads rows unit-stride along
    the head, or k and v in place along the keys (the slot-minor cache);
    any other bf16 tensor is first copied into rows it can read
    (:func:`_mma_rows`, counted in ``copies``). That is a copy on the card,
    not the plain version. Launches on the current stream and does not
    synchronise. Raises on anything else and if the launch is refused."""
    _check(q, k, v, causal, window)
    _check_cuda("flash_fwd_cuda", q, k, v)
    device = q.device
    b, h, n, d = q.shape
    hkv, kn, dv = k.shape[1], k.shape[2], v.shape[3]
    if dv > 128:
        raise ValueError(f"flash_fwd_cuda takes value heads up to 128 wide, got {dv}")
    planned = None
    if flash_route(q.dtype, d) == "mma":
        planned, (q, k, v) = _for_mma(flash_fwd_cuda, q, k, v)
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
    route, layout = _FWD_LAUNCHED[lib.flash_fwd_last_launch()]
    if planned == "c" and layout == "a":  # the wrapper's copies, read as rows
        layout = "c"
    flash_fwd_cuda.route, flash_fwd_cuda.layout = route, layout
    return o, lse


flash_fwd_cuda.launches = flash_fwd_cuda.copies = 0
flash_fwd_cuda.route = flash_fwd_cuda.layout = None


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
    kk = k.repeat_interleave(h // hkv, dim=1)
    vv = v.repeat_interleave(h // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", _wide(q), _wide(kk)) * softmax_scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    keep = _keep(b, n, kn, causal, window, segs, q_offset, k_offset, device)
    s = torch.where(keep[:, None], s, _MASKED)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", _wide(p.to(v.dtype)), _wide(vv))
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


# ---------------------------------------------------------------------------
# Backward.
# ---------------------------------------------------------------------------


def _delta(o, do):
    """rowsum(dO · O) in f32 from the forward's stored (rounded) o, as ku's
    _bwd_pallas forms it (:699)."""
    return (_wide(do) * _wide(o)).sum(dim=-1)


def _bwd_launch(entry, outs, q, k, v, do, lse, delta, *, softmax_scale=1.0,
                causal=False, window=None, segment_ids=None, q_offset=None,
                k_offset=None, logit_softcap=None):
    name = entry.__name__
    _check(q, k, v, causal, window)
    _check_cuda(name, q, k, v, do)
    device = q.device
    b, h, n, d = q.shape
    hkv, kn, dv = k.shape[1], k.shape[2], v.shape[3]
    if do.shape != (b, h, n, dv):
        raise ValueError(f"dO shape {tuple(do.shape)} != {(b, h, n, dv)}")
    if d > 128 or dv > 128:
        raise ValueError(f"{name} takes heads up to 128 wide, got {d} and {dv}")
    for t, what in ((lse, "lse"), (delta, "delta")):
        if t.shape != (b, h, n) or t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"{what} must be ({b}, {h}, {n}) float32 on {device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    lse, delta = lse.contiguous(), delta.contiguous()
    if flash_route(q.dtype, d) == "mma":
        _, (q, k, v, do) = _for_mma(entry, q, k, v, do)
    segs = _norm_segments(segment_ids, b, n, kn, device)
    q_off, k_off = _offsets(q_offset, b, device), _offsets(k_offset, b, device)
    strides = (ctypes.c_longlong * 16)(*q.stride(), *k.stride(), *v.stride(),
                                       *do.stride())
    lib = _bwd_library()
    err = getattr(lib, name.replace("_cuda", "_launch"))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), outs[0].data_ptr(),
        outs[1].data_ptr() if len(outs) > 1 else None,
        q_off.data_ptr(), k_off.data_ptr(),
        segs[0].data_ptr() if segs else None,
        segs[1].data_ptr() if segs else None,
        b, h, hkv, n, kn, d, dv, strides, float(softmax_scale),
        float(logit_softcap or 0.0), int(causal), int(window or 0),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.flash_bwd_error_string(err).decode()} ({err})")
    entry.launches += 1
    entry.route = ("f32", "mma")[lib.flash_bwd_last_launch()]


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw):
    """dq (B, H, N, D) in q's dtype as one launch of the dq kernel, from the
    forward's lse and ``delta`` = rowsum(dO·O) (both (B, H, N) f32).

    Takes CUDA tensors on one device, q/k/v/dO all f32 or all bf16 with any
    strides, the forward's keyword arguments. bf16 runs on the tensor cores,
    f32 on the CUDA cores (``route`` names the last launch's, as the C entry
    reports it); a bf16 tensor
    that is not :func:`_mma_ready` is first copied into rows that are
    (counted in ``copies``), a copy on the card and not the plain version.
    Launches on the current stream and does not synchronise. Raises on
    anything else and if the launch is refused."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch(flash_bwd_dq_cuda, (dq,), q, k, v, do, lse, delta, **kw)
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw):
    """(dk, dv) in the dtypes of k and v as one launch of the dk/dv kernel,
    each summed over the query heads of its KV head's group; the terms of
    :func:`flash_bwd_dq_cuda`."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch(flash_bwd_dkv_cuda, (dk, dv), q, k, v, do, lse, delta, **kw)
    return dk, dv


flash_bwd_dq_cuda.launches = flash_bwd_dkv_cuda.launches = 0
flash_bwd_dq_cuda.copies = flash_bwd_dkv_cuda.copies = 0
flash_bwd_dq_cuda.route = flash_bwd_dkv_cuda.route = None


def _bwd_slabs(q, k, v, do, lse, delta, *, softmax_scale=1.0, causal=False,
               window=None, segment_ids=None, q_offset=None, k_offset=None,
               logit_softcap=None):
    """The plain backward's (B, H, N, KN) slabs: (p, ds) in f32, p = 0 on
    masked pairs, and k repeated to H heads."""
    _check(q, k, v, causal, window)
    b, h, n, _ = q.shape
    hkv, kn = k.shape[1], k.shape[2]
    device = q.device
    segs = _norm_segments(segment_ids, b, n, kn, device)
    kk = k.repeat_interleave(h // hkv, dim=1)
    vv = v.repeat_interleave(h // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", _wide(q), _wide(kk)) * softmax_scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
        dcap = 1.0 - (s / logit_softcap) ** 2  # from the capped value
    keep = _keep(b, n, kn, causal, window, segs, q_offset, k_offset, device)
    # Masked pairs get p = 0 explicitly: a row with no live key has
    # lse = -1e30, and exp(s - lse) there would not vanish.
    p = torch.exp(torch.where(keep[:, None], s - lse[..., None], -torch.inf))
    dp = torch.einsum("bhqd,bhkd->bhqk", _wide(do), _wide(vv))
    ds = p * (dp - delta[..., None])
    if logit_softcap is not None:
        ds = ds * dcap
    return p, ds, kk


def flash_bwd_dq_torch(q, k, v, do, lse, delta, **kw):
    """The plain version of :func:`flash_bwd_dq_cuda`, on any device: ds
    rounded to k's dtype, dq = scale · ds·K summed in f32."""
    _, ds, kk = _bwd_slabs(q, k, v, do, lse, delta, **kw)
    dq = torch.einsum("bhqk,bhkd->bhqd", _wide(ds.to(k.dtype)), _wide(kk))
    return (kw.get("softmax_scale", 1.0) * dq).to(q.dtype)


def flash_bwd_dkv_torch(q, k, v, do, lse, delta, **kw):
    """The plain version of :func:`flash_bwd_dkv_cuda`, on any device: p
    rounded to dO's dtype, dv = pᵀ·dO; ds rounded to q's dtype, dk = scale ·
    dsᵀ·Q; each summed in f32 over the query heads of a group and rounded
    once."""
    p, ds, _ = _bwd_slabs(q, k, v, do, lse, delta, **kw)
    b, h, _, d = q.shape
    hkv, kn, dv = k.shape[1], k.shape[2], v.shape[3]
    dv_h = torch.einsum("bhqk,bhqd->bhkd", _wide(p.to(do.dtype)), _wide(do))
    dk_h = torch.einsum("bhqk,bhqd->bhkd", _wide(ds.to(q.dtype)), _wide(q))
    dk_h = kw.get("softmax_scale", 1.0) * dk_h
    group = h // hkv
    return (dk_h.view(b, hkv, group, kn, d).sum(2).to(k.dtype),
            dv_h.view(b, hkv, group, kn, dv).sum(2).to(v.dtype))


def flash_bwd_cuda(q, k, v, o, lse, do, **kw):
    """(dq, dk, dv) through the two backward kernels, from the forward's
    (o, lse) and the output's gradient ``do`` (any strides)."""
    delta = _delta(o, do)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    return (dq,) + flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)


def flash_bwd_torch(q, k, v, o, lse, do, **kw):
    """The plain version of :func:`flash_bwd_cuda`, on any device."""
    delta = _delta(o, do)
    dq = flash_bwd_dq_torch(q, k, v, do, lse, delta, **kw)
    return (dq,) + flash_bwd_dkv_torch(q, k, v, do, lse, delta, **kw)


def flash_bwd(q, k, v, o, lse, do, **kw):
    """The kernels for CUDA tensors, the plain versions for CPU tensors."""
    if q.device.type == "cuda":
        return flash_bwd_cuda(q, k, v, o, lse, do, **kw)
    if q.device.type == "cpu":
        return flash_bwd_torch(q, k, v, o, lse, do, **kw)
    raise ValueError(f"no flash attention for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """o = flash attention of (q, k, v), differentiable in q, k and v:
    forward :func:`flash_fwd`, backward :func:`flash_bwd` from the saved q,
    k, v, o and lse. ``kw`` holds the forward's keyword arguments (masks,
    offsets, segment ids), which get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        o, lse = flash_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, **ctx.kw)
        return dq, dk, dv, None


def flash_attention(q, k, v, **kw):
    """Flash attention's output (B, H, N, Dv): through :class:`FlashAttention`
    when gradients are wanted for q, k or v, else :func:`flash_fwd`'s output
    alone (serving, and anything under ``torch.no_grad()``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, kw)
    return flash_fwd(q, k, v, **kw)[0]


# ---------------------------------------------------------------------------
# Ring attention (sequence parallelism).
# ---------------------------------------------------------------------------


class _P2PRing:
    """This process's rank of a ring over one mesh dimension's process group.
    ``ranks`` is (this rank,); :meth:`rotate` sends each tensor to rank + 1
    and takes rank − 1's (the reverse with ``back``) through
    ``dist.batch_isend_irecv``. At world size 1 the rotation is the identity
    and no P2P op is issued."""

    def __init__(self, group, world: int, rank: int):
        import torch.distributed as dist

        self.group, self.world, self.ranks = group, world, (rank,)
        self._next = dist.get_global_rank(group, (rank + 1) % world)
        self._prev = dist.get_global_rank(group, (rank - 1) % world)

    def rotate(self, per_rank, back: bool = False):
        if self.world == 1:
            return per_rank
        import torch.distributed as dist

        (tensors,) = per_rank
        to, frm = (self._prev, self._next) if back else (self._next, self._prev)
        outs = tuple(torch.empty_like(t) for t in tensors)
        ops = []
        for t, o in zip(tensors, outs):
            ops += [dist.P2POp(dist.isend, t.contiguous(), to, self.group),
                    dist.P2POp(dist.irecv, o, frm, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [outs]

    def scatter(self, x, local: int):
        return [_SeqScatter.apply(x, self, local)]

    def gather(self, parts):
        return _SeqGather.apply(parts[0], self)

    def all_gather(self, x):
        """The ranks' ``x`` concatenated along the sequence (dim 2)."""
        if self.world == 1:
            return x
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=2)


class _EmulatedRing:
    """W ranks of a ring in one process, in rank order: ``ranks`` is
    0..W−1 and :meth:`rotate` hands rank r − 1's tensors to rank r (rank
    r + 1's with ``back``), where the P2P ring would send them."""

    def __init__(self, world: int):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.world, self.ranks = world, tuple(range(world))

    def rotate(self, per_rank, back: bool = False):
        w = self.world
        return [per_rank[(r + 1) % w if back else (r - 1) % w] for r in range(w)]

    def scatter(self, x, local: int):
        return [x.narrow(2, r * local, local) for r in self.ranks]

    def gather(self, parts):
        return torch.cat(parts, dim=2)


class _SeqScatter(torch.autograd.Function):
    """This rank's slice of the sequence (dim 2); backward all-gathers the
    slices' gradients, so that every rank holds the global gradient."""

    @staticmethod
    def forward(ctx, x, ring, local):
        ctx.ring = ring
        return x.narrow(2, ring.ranks[0] * local, local).contiguous()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return ctx.ring.all_gather(g), None, None


class _SeqGather(torch.autograd.Function):
    """The ranks' slices all-gathered along the sequence; backward keeps this
    rank's slice of the (replicated) output gradient."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring, ctx.local = ring, x.shape[2]
        return ring.all_gather(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return g.narrow(2, ctx.ring.ranks[0] * ctx.local, ctx.local), None


class _Rotate(torch.autograd.Function):
    """The ring's rotation, differentiable: the gradients rotate back."""

    @staticmethod
    def forward(ctx, ring, *tensors):
        ctx.ring = ring
        return ring.rotate([tensors])[0]

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        return (None,) + ctx.ring.rotate([grads], back=True)[0]


def _hop_kw(kw, seg_q, seg_k, q_off, k_off):
    """One hop's keyword arguments for the flash kernels: the masks, the
    segment ids of my queries and of the visiting key block, and the global
    offsets of both when causal (``ku``'s ``_hop_offsets``)."""
    out = dict(softmax_scale=kw["softmax_scale"], causal=kw["causal"], window=kw["window"])
    if kw["causal"]:
        out.update(q_offset=q_off, k_offset=k_off)
    if seg_q is not None:
        out["segment_ids"] = (seg_q, seg_k)
    return out


def _ring_fwd(ring, qs, ks, vs, seg_qs, seg_ks, kw):
    """W hops of the flash forward, one launch per rank and hop, every hop
    launched on every rank (a hop wholly in a rank's causal future masks
    every pair and merges with weight 0); the hops merged by log-sum-exp
    into an f32 (o, lse) carry, as ``ku``'s ``local_fwd_impl``. Returns each
    rank's (o in q's dtype, lse)."""
    w, local = ring.world, qs[0].shape[2]
    o = [torch.zeros(*q.shape[:3], v.shape[-1], dtype=torch.float32, device=q.device)
         for q, v in zip(qs, vs)]
    lse = [torch.full(q.shape[:3], _MASKED, dtype=torch.float32, device=q.device)
           for q in qs]
    blocks = [(k, v) + (() if seg_ks is None else (s,))
              for k, v, s in zip(ks, vs, seg_ks or ks)]
    for i in range(w):
        for j, my in enumerate(ring.ranks):
            src = (my - i) % w
            o_i, lse_i = flash_fwd(qs[j], blocks[j][0], blocks[j][1], **_hop_kw(
                kw, seg_qs and seg_qs[j], seg_ks and blocks[j][2], my * local, src * local))
            # A row with no live key in this hop has lse_i = -1e30 and o_i =
            # 0: its weight exp(lse_i - lse_new) is 0 once any hop had one.
            lse_new = torch.logaddexp(lse[j], lse_i)
            o[j] = (o[j] * torch.exp(lse[j] - lse_new)[..., None]
                    + o_i.float() * torch.exp(lse_i - lse_new)[..., None])
            lse[j] = lse_new
        if i < w - 1:  # the last hop's blocks are not needed again
            blocks = ring.rotate(blocks)
    return [x.to(q.dtype) for x, q in zip(o, qs)], lse


def _bwd_hop(q, k, v, do, lse, delta, **kw):
    if q.device.type == "cuda":
        return (flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw),) + \
            flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    if q.device.type == "cpu":
        return (flash_bwd_dq_torch(q, k, v, do, lse, delta, **kw),) + \
            flash_bwd_dkv_torch(q, k, v, do, lse, delta, **kw)
    raise ValueError(f"no flash attention for device {q.device}")


def _ring_bwd(ring, qs, ks, vs, os, lses, dos, seg_qs, seg_ks, kw):
    """The second ring pass, as ``ku``'s ``local_bwd_impl``: one launch each
    of the dq and the dk/dv kernel per rank and hop, from the merged o and
    the global lse (so a pair masked on its hop gets probability 0); dq
    sums at home in f32, dk/dv sum in f32 and travel with their block, so
    that after W rotations they are at the block's owner."""
    w, local = ring.world, qs[0].shape[2]
    deltas = [_delta(o, do) for o, do in zip(os, dos)]
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    blocks = [(k, v, torch.zeros(k.shape, dtype=torch.float32, device=k.device),
               torch.zeros(v.shape, dtype=torch.float32, device=v.device))
              + (() if seg_ks is None else (s,))
              for k, v, s in zip(ks, vs, seg_ks or ks)]
    for i in range(w):
        for j, my in enumerate(ring.ranks):
            src = (my - i) % w
            k, v, dk, dv = blocks[j][:4]
            dq_i, dk_i, dv_i = _bwd_hop(qs[j], k, v, dos[j], lses[j], deltas[j], **_hop_kw(
                kw, seg_qs and seg_qs[j], seg_ks and blocks[j][4], my * local, src * local))
            dq[j] += dq_i.float()
            blocks[j] = (k, v, dk + dk_i.float(), dv + dv_i.float()) + blocks[j][4:]
        if i < w - 1:
            blocks = ring.rotate(blocks)
        else:  # only the gradients go home
            blocks = ring.rotate([b[2:4] for b in blocks])
    return ([x.to(q.dtype) for x, q in zip(dq, qs)],
            [b[0].to(k.dtype) for b, k in zip(blocks, ks)],
            [b[1].to(v.dtype) for b, v in zip(blocks, vs)])


class _RingFlash(torch.autograd.Function):
    """The ``impl="pallas"`` ring: each rank's local (q, k, v) → its o, with
    the kernels' backward (``ku``'s ``local_pallas`` custom_vjp). Tensors
    come flat, rank by rank: q_0..q_{n-1}, k_0.., v_0..."""

    @staticmethod
    def forward(ctx, ring, kw, seg_qs, seg_ks, *qkv):
        n = len(ring.ranks)
        qs, ks, vs = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        os, lses = _ring_fwd(ring, qs, ks, vs, seg_qs, seg_ks, kw)
        ctx.save_for_backward(*qkv, *os, *lses)
        ctx.ring, ctx.kw, ctx.segs = ring, kw, (seg_qs, seg_ks)
        return tuple(os)

    @staticmethod
    @once_differentiable
    def backward(ctx, *dos):
        n = len(ctx.ring.ranks)
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        os, lses = saved[3 * n:4 * n], saved[4 * n:]
        dq, dk, dv = _ring_bwd(ctx.ring, qs, ks, vs, os, lses, dos, *ctx.segs, ctx.kw)
        return (None, None, None, None, *dq, *dk, *dv)


def _online_block_update(q, k_blk, v_blk, m, l, acc, scale, q_pos, k_pos_start,
                         k_len, causal, chunk=512, window=None, seg_q=None,
                         seg_k_blk=None):
    """``ku``'s ``_online_block_update`` in plain torch: merge one K/V block
    into an online-softmax carry (m, l, acc) in ``chunk``-wide pieces, the
    block padded to whole chunks (padded keys masked). Masked scores are
    -1e30, so a row with no live key at all averages V, padding included,
    as ``ku``'s does."""
    kn = k_blk.shape[2]
    chunk = min(chunk, kn)
    num = -(-kn // chunk)
    pad = num * chunk - kn
    if pad:
        k_blk = torch.nn.functional.pad(k_blk, (0, 0, 0, pad))
        v_blk = torch.nn.functional.pad(v_blk, (0, 0, 0, pad))
        if seg_q is not None:
            seg_k_blk = torch.nn.functional.pad(seg_k_blk, (0, pad), value=-1)
    for ci in range(num):
        k_i = k_blk[:, :, ci * chunk:(ci + 1) * chunk]
        v_i = v_blk[:, :, ci * chunk:(ci + 1) * chunk]
        s = torch.einsum("bhqd,bhkd->bhqk", q, k_i) * scale
        k_pos_i = k_pos_start + ci * chunk + torch.arange(chunk, device=q.device)
        mask = (k_pos_i - k_pos_start < k_len)[None, :]
        if causal:
            mask = mask & (k_pos_i[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos_i[None, :] < window)
        s = torch.where(mask[None, None], s, _MASKED)
        if seg_q is not None:
            seg_k_i = seg_k_blk[:, ci * chunk:(ci + 1) * chunk]
            s = torch.where((seg_q[:, :, None] == seg_k_i[:, None, :])[:, None], s, _MASKED)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_i.to(p.dtype))
        m = m_new
    return m, l, acc


def _ring_xla(ring, qs, ks, vs, seg_qs, seg_ks, kw, chunk):
    """``ku``'s ``impl="xla"`` ring (``local_xla``) in plain torch, autograd
    through it; the P2P ring's rotation is differentiable (:class:`_Rotate`)."""
    w, local = ring.world, qs[0].shape[2]
    rotate = ring.rotate if isinstance(ring, _EmulatedRing) else (
        lambda per_rank: [_Rotate.apply(ring, *per_rank[0])])
    wide = dict(dtype=torch.promote_types(qs[0].dtype, torch.float32), device=qs[0].device)
    carry = [(torch.full(q.shape[:3], _MASKED, **wide), torch.zeros(q.shape[:3], **wide),
              torch.zeros(*q.shape[:3], v.shape[-1], **wide)) for q, v in zip(qs, vs)]
    blocks = list(zip(ks, vs))
    segs = seg_ks
    for i in range(w):
        for j, my in enumerate(ring.ranks):
            src = (my - i) % w
            q_pos = my * local + torch.arange(local, device=qs[j].device)
            carry[j] = _online_block_update(
                qs[j], blocks[j][0], blocks[j][1], *carry[j], kw["softmax_scale"], q_pos,
                src * local, local, kw["causal"], chunk, window=kw["window"],
                seg_q=seg_qs and seg_qs[j], seg_k_blk=segs and segs[j])
        if i < w - 1:
            blocks = rotate(blocks)
            if segs is not None:
                segs = [s[0] for s in ring.rotate([(s,) for s in segs])]
    return [(acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
            for (_, l, acc), q in zip(carry, qs)]


def _ring(ring, q, k, v, softmax_scale, causal, chunk, impl, window, segment_ids):
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if impl not in ("pallas", "xla"):
        raise ValueError(f"impl must be 'pallas' or 'xla', got {impl!r}")
    _check(q, k, v, causal, window)
    b, h, n, _ = q.shape
    if k.shape[2] != n:
        raise ValueError(f"ring attention is self-attention: {n} queries, "
                         f"{k.shape[2]} keys")
    if n % ring.world:
        raise ValueError(f"sequence length {n} does not divide over {ring.world} ranks")
    local = n // ring.world
    segs = _norm_segments(segment_ids, b, n, n, q.device)
    if impl == "xla" and k.shape[1] != h:
        # GQA: the plain update wants matched heads (ku repeats them too).
        k = k.repeat_interleave(h // k.shape[1], dim=1)
        v = v.repeat_interleave(h // v.shape[1], dim=1)
    qs, ks, vs = (ring.scatter(x, local) for x in (q, k, v))
    seg_qs = seg_ks = None
    if segs is not None:
        seg_qs = [segs[0][:, r * local:(r + 1) * local] for r in ring.ranks]
        seg_ks = [segs[1][:, r * local:(r + 1) * local].contiguous() for r in ring.ranks]
    kw = dict(softmax_scale=softmax_scale, causal=causal, window=window)
    if impl == "pallas":
        outs = list(_RingFlash.apply(ring, kw, seg_qs, seg_ks, *qs, *ks, *vs))
    else:
        outs = _ring_xla(ring, qs, ks, vs, seg_qs, seg_ks, kw, chunk)
    return ring.gather(outs)


def ring_attention(q, k, v, mesh, axis_name: str = "data", softmax_scale: float = 1.0,
                   causal: bool = False, chunk: int = 512, impl: str = "pallas",
                   window: Optional[int] = None, segment_ids=None):
    """Sequence-parallel self-attention over the ``axis_name`` dimension of
    ``mesh`` (a ``DeviceMesh``, :func:`ku_torch.dist.make_mesh`), ``ku``'s
    ``ring_attention``.

    Every rank passes the same GLOBAL q (B, H, N, D), k/v (B, Hkv, N, D) and
    (B, N) ``segment_ids``; N must divide by the W ranks. Each rank keeps its
    N/W queries (and their segment ids); the K/V blocks (and the key segment
    ids) rotate to rank + 1 each hop, through ``batch_isend_irecv`` over the
    dimension's process group (at W = 1 the rotation is skipped: no P2P op).
    The ranks' outputs are all-gathered along N and the global output is
    returned; its gradient reaches q, k and v as the global gradients (each
    rank's slices all-gathered), for a loss that every rank computes alike.

    ``impl="pallas"``: each hop launches the flash forward kernel (#3) at
    the global offsets of my queries and of the visiting keys (causal), the
    hops merged by log-sum-exp in f32; the backward is a second ring pass of
    the dq and dk/dv kernels (#4) from the merged output and the global lse
    (W launches of each a call and rank). On CPU tensors the kernels' plain
    versions run. ``impl="xla"``: ``ku``'s chunked online-softmax update in
    plain torch (``chunk`` wide), GQA by repeating the KV heads, autograd
    through it; no kernel. ``window`` (requires ``causal``) is a sliding
    window over global positions.

    A query row with no live key on a hop gets o = 0 and lse = -1e30 from
    the kernel and merges with weight 0; a row with no live key at all
    gets 0 from ``"pallas"`` and ``ku``'s mean of V from ``"xla"``."""
    from ku_torch.dist.mesh import axis_info

    group, world, rank = axis_info(mesh, axis_name)
    return _ring(_P2PRing(group, world, rank), q, k, v, softmax_scale, causal, chunk,
                 impl, window, segment_ids)


def ring_attention_emulated(q, k, v, world: int, softmax_scale: float = 1.0,
                            causal: bool = False, chunk: int = 512,
                            impl: str = "pallas", window: Optional[int] = None,
                            segment_ids=None):
    """:func:`ring_attention` with ``world`` ranks emulated in one process
    (a test aid, as ``cd_gibbs_dp.cd_train_dp_emulated``): the same per-hop
    code runs for each rank in rank order and the rotation hands each rank
    its predecessor's block, so W ranks run on one device. ``"pallas"``
    launches W² forward kernels a call (W per rank) and as many of each
    backward kernel."""
    return _ring(_EmulatedRing(world), q, k, v, softmax_scale, causal, chunk, impl,
                 window, segment_ids)
