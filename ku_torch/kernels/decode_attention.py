"""Flash-decoding over a dense KV cache and over a paged one, as CUDA
kernels, with their plain versions.

Port of ``ku/pallas/decode_attention.py``. One source,
``ku_torch/csrc/decode_attention.cu``, holds one online-softmax fold with two
ways of addressing a slot: it replaces ``_kernel`` (dense) and the three
paged variants ``_paged_kernel``, ``_paged_kernel_v3`` and
``_paged_kernel_v4``. Each (row, KV head) is a cluster of :data:`S_SPLIT`
blocks: block r folds the r-th chunk of the row's live slots
(:func:`split_plan`, a plan that depends on the row's clamped length alone)
for the G query heads of that KV head, streaming its tiles of :data:`TILE`
slots through a ring of 16-byte ``cp.async`` copies and folding them on
the tensor cores where q and the cache are bf16 (:func:`fold_route`), on
the CUDA cores otherwise, and the blocks merge their partials (m, l, acc)
in distributed shared memory in the fixed order 0..S_SPLIT-1. The source
note says what bounds the kernel on an H100 (the bytes of the live K/V, a
few microseconds at the serving shapes) and how the design fights the
latency that is left.

- :func:`decode_attention_cuda` / :func:`decode_attention_paged_cuda` launch
  the kernel. They take CUDA tensors only and add one to their
  ``launches`` per launch. :func:`last_launch` says what the C entry
  launched last: its copy route (:func:`copy_route`), its fold
  (:func:`fold_route`), its stages and its blocks a cluster.
- :func:`decode_attention_torch` / :func:`decode_attention_paged_torch` are
  the plain versions: the same function in torch ops, on any device.
- :func:`decode_attention` / :func:`decode_attention_paged` pick by the
  device of ``q``: the kernel for a CUDA tensor, the plain version for a CPU
  tensor. They never fall back from one to the other.

Dense contract, as ``ku.pallas.decode_attention.decode_attention``: ``q`` is
(B, Hkv, G, D), the cache ``k``/``v`` is (B, Hkv, D, S)/(B, Hkv, Dv, S) with
the slot axis minor, ``lengths`` (B,) int32 counts each row's live slots
(values above S read all S), and int8 caches come with (B, Hkv, S) f32
``k_scale``/``v_scale``. The result is (B, Hkv, G, Dv) in ``q``'s dtype,
accumulated in f32, with the probabilities rounded to ``q``'s dtype before
the PV product; a row of length <= 0 gets 0. ``softmax_scale`` defaults to
1/sqrt(D). On the card G is at most 16 and Dv at most 128.

Paged contract, as ``ku.pallas.decode_attention.decode_attention_paged``:
the pools are (NP, Hkv, D, pg)/(NP, Hkv, Dv, pg), slot axis minor, int8
pools with (NP, Hkv, pg) f32 scales; ``page_table`` (B, MP) int32 names the
pool page of each of a row's logical pages. The row reads exactly the dense
function over its gathered (B, Hkv, D, MP·pg) view, without building it:
only its first ceil(length/pg) table entries are read (a dead entry may
hold anything, even a page of NaN), a length above MP·pg reads the whole
window unmasked, and a row of length <= 0 gets 0 (``ku``'s path never makes
one). Any ``pg`` >= 1 (``ku``'s ``pg % 128`` is a constraint of the TPU's
compiler). ``pipelined`` (False, True or ``"v4"``) is accepted and ignored:
``ku``'s three variants differ only in DMA scheduling and are bit-exact.
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
S_SPLIT = 8  # blocks of a cluster: the chunks of a row's live slots
TILE = 64  # slots of a tile; a chunk is a multiple of it


def split_chunk(length: int) -> int:
    """The slots of each chunk of a row of ``length`` live slots (already
    clamped to its window), as the kernel plans it: ceil(length / S_SPLIT)
    rounded up to a whole tile; 0 for length <= 0."""
    if length <= 0:
        return 0
    per = -(-length // S_SPLIT)
    return -(-per // TILE) * TILE


def split_plan(length: int) -> list:
    """The chunk [start, stop) that block r = 0..S_SPLIT-1 of a row's
    cluster folds, for a row of ``length`` live slots (already clamped to
    its window): consecutive chunks of :func:`split_chunk` slots, the last
    cut at ``length``; a block past it gets an empty chunk (start == stop)
    and reads nothing. The plan depends on the length alone, never on B, S,
    pg or MP, so a paged and a dense read of the same slots, or a row alone
    and in a batch, fold alike."""
    n = max(length, 0)
    c = split_chunk(n)
    return [(min(r * c, n), min((r + 1) * c, n)) for r in range(S_SPLIT)]


def copy_route(k, v, k_scale=None, v_scale=None) -> str:
    """How a launch reads the cache or pools, from their shapes and start
    addresses alone, as the C entries decide it: ``"16-byte"`` copies where
    every 16-byte segment of the slot axis is whole and aligned (S or pg a
    multiple of 16 / itemsize slots, every base 16-byte aligned), else
    ``"element"`` loads. Both run the same fold."""
    whole = k.shape[-1] % (16 // k.element_size()) == 0
    bases = [k, v] + ([k_scale, v_scale] if k_scale is not None else [])
    return "16-byte" if whole and all(t.data_ptr() % 16 == 0 for t in bases) else "element"


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build(SOURCE, NAME)[0]))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention_launch.argtypes = [p] * 7 + [i] * 6 + [f, f, i, i, p]
    lib.decode_attention_launch.restype = i
    lib.decode_attention_paged_launch.argtypes = [p] * 8 + [i] * 7 + [f, f, i, i, p]
    lib.decode_attention_paged_launch.restype = i
    lib.decode_attention_last_launch.argtypes = []
    lib.decode_attention_last_launch.restype = i
    lib.decode_attention_split_chunk.argtypes = [i]
    lib.decode_attention_split_chunk.restype = i
    lib.decode_attention_error_string.argtypes = [i]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def last_launch() -> Optional[dict]:
    """What the last launch of either C entry took, as it reports it:
    ``{"route": "16-byte" or "element", "fold": "mma" or "fma", "stages":
    its ring's stages, "s_split": its blocks a cluster, "clusters": how many
    of its clusters the card holds at once}``; None before the first
    launch."""
    code = _library().decode_attention_last_launch()
    if code < 0:
        return None
    return {"route": ("element", "16-byte")[code & 1], "fold": fold(code >> 8 & 1),
            "stages": (code >> 1) & 7, "s_split": (code >> 4) & 15,
            "clusters": code >> 9}


def fold(on_tensor_cores) -> str:
    """The name of a fold: ``"mma"`` on the tensor cores, ``"fma"`` on the
    CUDA cores."""
    return "mma" if on_tensor_cores else "fma"


def fold_route(q, k, v) -> str:
    """Where a launch folds, from dtypes and shapes, as the C entries decide
    it: the tensor cores (``"mma"``: bf16 q and K/V, G <= 4, D <= 128 and
    D, Dv multiples of 16, q 4-byte aligned), else the CUDA cores
    (``"fma"``)."""
    g, d, dv = q.shape[2], q.shape[3], v.shape[2]
    return fold(q.dtype == k.dtype == torch.bfloat16 and g <= 4 and d % 16 == 0
                and d <= 128 and dv % 16 == 0 and q.data_ptr() % 4 == 0)


def _check(q, k, v, lengths, k_scale, v_scale, page_table=None):
    """Shapes and dtypes; K/V's first axis is B (dense) or the pool's NP
    (paged, with ``page_table``)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("decode_attention takes q (B, Hkv, G, D) and a cache "
                         "(B, Hkv, D, S) or pools (NP, Hkv, D, pg)")
    bsz, hkv, _, d = q.shape
    units = bsz if page_table is None else k.shape[0]
    s = k.shape[3]
    if k.shape[:3] != (units, hkv, d) or v.shape[:2] != (units, hkv) \
            or v.shape[3] != s:
        raise ValueError(f"cache shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if page_table is not None and (page_table.dim() != 2
                                   or page_table.shape[0] != bsz):
        raise ValueError(f"page_table shape {tuple(page_table.shape)} is not "
                         f"({bsz}, MP)")
    if lengths.shape != (bsz,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({bsz},)")
    quant = k_scale is not None
    if quant != (v_scale is not None) or quant != (k.dtype == torch.int8) \
            or k.dtype != v.dtype:
        raise ValueError("int8 caches take k_scale and v_scale; others neither")
    if quant and (k_scale.shape != (units, hkv, s)
                  or v_scale.shape != (units, hkv, s)):
        raise ValueError(f"scales must be ({units}, {hkv}, {s})")
    if not quant and k.dtype != q.dtype:
        raise ValueError(f"cache dtype {k.dtype} != query dtype {q.dtype}")


def _check_launch(name, q, v, tensors, int32s, k_scale, v_scale):
    """What the kernel takes beyond the contract: contiguous CUDA tensors on
    one device, f32 or bf16 queries, int32 lengths and table, f32 scales,
    G <= 16, Dv <= 128; never a tracer's fake tensors."""
    _build.refuse_tracing(name, *tensors)
    device = q.device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name} takes CUDA tensors on one device, got "
                             f"{t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    if device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors on one device, got {device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} takes f32 or bf16 queries, got {q.dtype}")
    for what, t in int32s:
        if t.dtype != torch.int32:
            raise ValueError(f"{what} must be int32")
    if k_scale is not None and (k_scale.dtype != torch.float32
                                or v_scale.dtype != torch.float32):
        raise ValueError("k_scale and v_scale must be float32")
    g, dv = q.shape[2], v.shape[2]
    if g > 16 or dv > 128:
        raise ValueError(f"{name} takes up to 16 query heads per KV head and "
                         f"value heads up to 128 wide, got {g}, {dv}")


def _raise_on(err, what):
    if err != 0:
        lib = _library()
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.decode_attention_error_string(err).decode()} "
                           f"({err})")


def _stream(q) -> int:
    """The current CUDA stream of q's device, as the raw handle the C
    entries take (PyTorch's own lookup, without building a Stream object:
    a few microseconds less of host time on every launch)."""
    return torch._C._cuda_getCurrentRawStream(q.device.index)


def _scale(q, softmax_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if softmax_scale is None else softmax_scale


def decode_attention_cuda(q, k, v, lengths, *, k_scale=None, v_scale=None,
                          softmax_scale: Optional[float] = None,
                          logit_softcap: Optional[float] = None):
    """Single-token attention over the dense cache as one launch of the
    kernel.

    Takes contiguous CUDA tensors on one device: q f32 or bf16, the cache in
    q's dtype or int8 with f32 scales, lengths int32. Launches on the
    current stream and does not synchronise. Raises on anything else and
    if the launch is refused."""
    _check(q, k, v, lengths, k_scale, v_scale)
    scales = [k_scale, v_scale] if k_scale is not None else []
    _check_launch("decode_attention_cuda", q, v, [q, k, v, lengths] + scales,
                  [("lengths", lengths)], k_scale, v_scale)
    bsz, hkv, g, d = q.shape
    dv, s = v.shape[2], k.shape[3]
    out = torch.empty(bsz, hkv, g, dv, dtype=q.dtype, device=q.device)
    err = _library().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        out.data_ptr(), bsz, hkv, g, d, dv, s, float(_scale(q, softmax_scale)),
        float(logit_softcap or 0.0), _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[k.dtype], _stream(q))
    _raise_on(err, "decode_attention")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0


def decode_attention_paged_cuda(q, k_pool, v_pool, page_table, lengths, *,
                                k_scale=None, v_scale=None,
                                softmax_scale: Optional[float] = None,
                                logit_softcap: Optional[float] = None,
                                pipelined=False):
    """Single-token attention over the page pool through ``page_table``, as
    one launch of the kernel.

    Takes contiguous CUDA tensors on one device: q f32 or bf16, the pools in
    q's dtype or int8 with f32 scales, table and lengths int32. A live table
    entry must name a page of the pool; dead ones are never read. Launches
    on the current stream and does not synchronise. Raises on anything else
    and if the launch is refused. ``pipelined`` is ignored (module
    docstring)."""
    del pipelined
    _check(q, k_pool, v_pool, lengths, k_scale, v_scale, page_table)
    scales = [k_scale, v_scale] if k_scale is not None else []
    _check_launch("decode_attention_paged_cuda", q, v_pool,
                  [q, k_pool, v_pool, page_table, lengths] + scales,
                  [("lengths", lengths), ("page_table", page_table)],
                  k_scale, v_scale)
    bsz, hkv, g, d = q.shape
    dv, pg = v_pool.shape[2], k_pool.shape[3]
    out = torch.empty(bsz, hkv, g, dv, dtype=q.dtype, device=q.device)
    err = _library().decode_attention_paged_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        out.data_ptr(), bsz, hkv, g, d, dv, pg, page_table.shape[1],
        float(_scale(q, softmax_scale)), float(logit_softcap or 0.0),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype], _stream(q))
    _raise_on(err, "decode_attention_paged")
    decode_attention_paged_cuda.launches += 1
    return out


decode_attention_paged_cuda.launches = 0


def gather_pages(pool, page_table):
    """Each row's view of a page pool through its table, slot axis minor:
    (NP, Hkv, X, pg) -> (B, Hkv, X, MP·pg), or scales (NP, Hkv, pg) ->
    (B, Hkv, MP·pg). Every table entry must name a page of the pool."""
    bsz, mp = page_table.shape
    g = pool[page_table.long()]  # (B, MP, Hkv, [X,] pg)
    if pool.dim() == 3:
        return g.permute(0, 2, 1, 3).reshape(bsz, pool.shape[1], -1)
    return g.permute(0, 2, 3, 1, 4).reshape(bsz, pool.shape[1], pool.shape[2], -1)


def _fold_torch(q, k, v, live, k_scale, v_scale, softmax_scale, logit_softcap):
    """The plain read of K/V (B, Hkv, D, S) at the slots where ``live``
    (B, S) holds: the softmax over all S at once instead of tile by tile.
    What a dead slot holds (K, V or scales, even NaN) never reaches the
    result."""
    s = torch.einsum("bhgd,bhds->bhgs", q.float(), k.to(q.dtype).float())
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    s = s * softmax_scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    live4 = live[:, None, None, :]
    s = torch.where(live4, s, _MASKED)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * torch.where(live[:, None, :], v_scale, 0.0)[:, :, None, :]
    p = p.to(q.dtype).float()
    vf = torch.where(live4, v.to(q.dtype).float(), 0.0)
    o = torch.einsum("bhgs,bhds->bhgd", p, vf) / l
    o = torch.where(live.any(dim=-1)[:, None, None, None], o, 0.0)
    return o.to(q.dtype)


def decode_attention_torch(q, k, v, lengths, *, k_scale=None, v_scale=None,
                           softmax_scale: Optional[float] = None,
                           logit_softcap: Optional[float] = None):
    """The plain version of :func:`decode_attention_cuda`, on any device:
    the same scores, masks and roundings, the softmax taken over all S slots
    at once instead of tile by tile."""
    _check(q, k, v, lengths, k_scale, v_scale)
    slot = torch.arange(k.shape[3], device=q.device)
    live = slot[None, :] < lengths.to(q.device)[:, None].long()
    return _fold_torch(q, k, v, live, k_scale, v_scale,
                       _scale(q, softmax_scale), logit_softcap)


def decode_attention_paged_torch(q, k_pool, v_pool, page_table, lengths, *,
                                 k_scale=None, v_scale=None,
                                 softmax_scale: Optional[float] = None,
                                 logit_softcap: Optional[float] = None,
                                 pipelined=False):
    """The plain version of :func:`decode_attention_paged_cuda`, on any
    device: the dense plain read over each row's gathered (Hkv, D, MP·pg)
    view, in which dead table entries are replaced by page 0 before the
    gather and dead slots are masked."""
    del pipelined
    _check(q, k_pool, v_pool, lengths, k_scale, v_scale, page_table)
    mp, pg = page_table.shape[1], k_pool.shape[3]
    device = q.device
    lengths = lengths.to(device).long().clamp(max=mp * pg)
    live_pages = (torch.arange(mp, device=device)[None, :]
                  < (lengths[:, None] + pg - 1) // pg)
    table = torch.where(live_pages, page_table.to(device).long(), 0)
    live = torch.arange(mp * pg, device=device)[None, :] < lengths[:, None]
    k_scale, v_scale = (None if s is None else gather_pages(s, table)
                        for s in (k_scale, v_scale))
    return _fold_torch(q, gather_pages(k_pool, table),
                       gather_pages(v_pool, table), live, k_scale, v_scale,
                       _scale(q, softmax_scale), logit_softcap)


def _by_device(cuda_fn, torch_fn, q, *args, **kw):
    if q.device.type == "cuda":
        return cuda_fn(q, *args, **kw)
    if q.device.type == "cpu":
        return torch_fn(q, *args, **kw)
    raise ValueError(f"no decode attention for device {q.device}")


def decode_attention(q, k, v, lengths, *, k_scale=None, v_scale=None,
                     softmax_scale: Optional[float] = None,
                     logit_softcap: Optional[float] = None):
    """The dense kernel for CUDA tensors, its plain version for CPU
    tensors."""
    return _by_device(decode_attention_cuda, decode_attention_torch, q, k, v,
                      lengths, k_scale=k_scale, v_scale=v_scale,
                      softmax_scale=softmax_scale, logit_softcap=logit_softcap)


def decode_attention_paged(q, k_pool, v_pool, page_table, lengths, *,
                           k_scale=None, v_scale=None,
                           softmax_scale: Optional[float] = None,
                           logit_softcap: Optional[float] = None,
                           pipelined=False):
    """The paged kernel for CUDA tensors, its plain version for CPU
    tensors."""
    return _by_device(decode_attention_paged_cuda, decode_attention_paged_torch,
                      q, k_pool, v_pool, page_table, lengths, k_scale=k_scale,
                      v_scale=v_scale, softmax_scale=softmax_scale,
                      logit_softcap=logit_softcap, pipelined=pipelined)
