"""Block-sparse flash attention over host-built flat block maps: the maps
themselves, three CUDA kernels with their plain versions, and the autograd
function that joins them.

Port of ``ku/pallas/sparse_attention.py``.

- :func:`make_block_mask` and :class:`BlockMask` build ``ku``'s maps in numpy,
  bit for bit: ``fmap`` (entries grouped by query block) drives the
  forward and dq, ``tmap`` (grouped by key block) dk/dv, both (E, 5) int32
  ``[q_block, k_block, flag, first, last]``; ``kcnt`` / ``qcnt`` count each
  block's live partners. :meth:`BlockMask.arrays` adds where each run
  starts (``fptr`` by query block, ``tptr`` by key block) and moves the four
  arrays to a device once per (mask, device): a layer called many times a
  step makes no host-to-device copy and no sync in any call.
- ``ku_torch/csrc/sparse_attention.cu`` replaces ``_sparse_fwd_kernel``,
  ``_sparse_dq_kernel`` and ``_sparse_dkv_kernel``: the forward and dq from
  one block per (batch·head, 64-query sub-tile of a query block) that walks
  its query block's run of ``fmap``, dk/dv from one block per (batch·KV
  head, 64-key sub-tile of a key block) that walks its key block's run of
  ``tmap`` for every query head of the group. Two routes, by dtype: bf16 on
  the tensor cores (warpgroup ``wgmma`` over swizzled bf16 tiles that
  ``cp.async`` fills, ``ku_torch/csrc/attn_mma.cuh``), f32 on the CUDA
  cores. The source's
  notes say what bounds them on an H100.
- :func:`sparse_fwd_cuda`, :func:`sparse_bwd_dq_cuda` and
  :func:`sparse_bwd_dkv_cuda` launch the kernels on CUDA tensors and add one
  to their ``launches`` count per launch; :func:`sparse_fwd_torch`,
  :func:`sparse_bwd_dq_torch` and :func:`sparse_bwd_dkv_torch` are the plain
  versions on any device. They walk the same maps a block at a time (a query
  block's live key blocks gathered, or a key block's live query blocks), so
  they never build an N × KN matrix; the backward ones are the backward
  formula written out, not autograd over the forward.
- :func:`sparse_fwd` / :func:`sparse_bwd` pick by ``q.device``: the kernels
  for a CUDA tensor, the plain versions for a CPU tensor, never one for the
  other. :func:`sparse_attention` is what ``MultiHeadAttention(block_mask=
  ...)`` calls: through :class:`SparseAttention` (``ku``'s
  ``jax.custom_vjp``) when gradients are wanted, the forward alone under
  ``torch.no_grad()``.

Contract, as ``ku``'s ``sparse_attention``: q (B, H, N, D), k/v (B, Hkv,
KN, D)/(B, Hkv, KN, Dv), H a multiple of Hkv (query head j reads KV head
j // (H/Hkv)), N and KN those of the mask. Per entry, the element mask of
``_mask_sparse``: a ``_FULL`` entry keeps every pair; the others keep
``k <= q`` if the mask is causal, and with a window also ``q - k < window``
or ``k < global_prefix`` (a ``_CAUSAL_ONLY`` entry is exempt from that
clause). On the card: f32 or bf16, any strides (a bf16 tensor whose rows
the tensor-core kernels cannot copy as they lie is copied first, see
:func:`sparse_fwd_cuda`), D and Dv up to 128, any block sizes. The forward returns (o (B, H, N, Dv) in q's dtype, lse (B, H,
N) f32); the backward (dq, dk, dv) in the dtypes of q, k and v, dk/dv
summed over each KV head's group in f32 and rounded once. bf16 is rounded
where ``ku`` rounds it: p to v's dtype before P·V; ds to k's dtype for dq;
p to dO's dtype for dv; ds to q's dtype for dk.

Where the port differs from ``ku`` (ROADMAP §3): a query row with no live
key (a block pattern whose only live block for the row lies after it, or a
window over a shorter key axis) gets o = 0 and lse = -1e30, and its
probabilities are 0 in the backward, as in the flash kernels; ``ku`` returns
the mean of the masked values there. A key block that no query attends gets
dk = dv = 0 without its K or V ever being read.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ku_torch.kernels import _build
from ku_torch.kernels.flash_attention import (_DTYPE_CODES, _check_cuda, _delta, _mma_ready,
                                              _mma_rows, _wide, flash_route)

NAME = "sparse_attention"
SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "sparse_attention.cu"
_NEG_INF = -1e30

# Per-entry element-mask flags (host-computed), as ku.
_FULL = 0         # every (q, k) in the block passes: no mask pass
_PARTIAL = 1      # causal AND (window OR global-prefix) element mask
_CAUSAL_ONLY = 2  # window-exempt block (extra/pattern): causal mask only

# Flat-map entry columns: [q_block, k_block, flag, first_of_run,
# last_of_run].
_QI, _KB, _FLAG, _FIRST, _LAST = range(5)


@dataclasses.dataclass(frozen=True)
class BlockMask:
    """Host-precomputed flat block maps for one static pattern, as ``ku``'s.

    Build with :func:`make_block_mask`. ``fmap`` drives the forward and dq
    kernels (entries grouped by query block), ``tmap`` the dk/dv kernel
    (grouped by key block); both are (E, 5) int32 [qi, kb, flag, first,
    last] where first/last bound each run. ``kcnt``/``qcnt`` are per-block
    live counts."""

    n: int
    kn: int
    block_q: int
    block_k: int
    causal: bool
    window: Optional[int]
    global_prefix: int
    fmap: np.ndarray
    tmap: np.ndarray
    kcnt: np.ndarray
    qcnt: np.ndarray
    _on_device: dict = dataclasses.field(default_factory=dict, init=False,
                                         repr=False, compare=False)

    @property
    def meta(self):
        """Hashable static kernel config."""
        return (self.causal, self.window, self.global_prefix)

    def arrays(self, device):
        """(fmap, tmap, fptr, tptr) int32 on ``device``, made at the first
        call for that device and kept: ``fptr`` (nqb + 1,) and ``tptr`` (nkb
        + 1,) are where each query block's run of ``fmap`` and each key
        block's run of ``tmap`` start (an unattended key block's run is
        empty)."""
        key = str(torch.device(device))
        if key not in self._on_device:
            fptr = np.concatenate([[0], np.cumsum(self.kcnt)])
            tptr = np.concatenate([[0], np.cumsum(self.qcnt)])
            self._on_device[key] = tuple(
                torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)
                for a in (self.fmap, self.tmap, fptr, tptr))
        return self._on_device[key]

    @property
    def sparsity(self) -> float:
        """Fraction of (q block, k block) pairs NOT visited."""
        total = (self.n // self.block_q) * (self.kn // self.block_k)
        return 1.0 - self.fmap.shape[0] / total


def _flat_runs(live, flag, by_col=False):
    """Flatten a (nqb, nkb) block-liveness matrix into flat run entries
    (E, 5) int32 [qi, kb, flag, first, last], grouped by row (q-major,
    ``by_col=False``) or by column (k-major)."""
    entries = []
    outer = live.T if by_col else live
    for r in range(outer.shape[0]):
        cols = np.nonzero(outer[r])[0]
        for i, c in enumerate(cols):
            qi, kb = (c, r) if by_col else (r, c)
            entries.append((qi, kb, flag[qi, kb], int(i == 0),
                            int(i == len(cols) - 1)))
    if not entries:
        raise ValueError("empty block pattern: no live blocks")
    return np.asarray(entries, np.int32)


def make_block_mask(n, kn=None, block_q: int = 512, block_k: int = 512,
                    *, causal: bool = False, window: Optional[int] = None,
                    global_prefix: int = 0, extra_blocks=(),
                    block_pattern=None) -> BlockMask:
    """Compile a static attention pattern to flat block maps (host), as
    ``ku.pallas.sparse_attention.make_block_mask``.

    ``window`` (requires ``causal``): sliding-window band, from which
    ``global_prefix`` keys (attention sinks, StreamingLLM-style) and
    ``extra_blocks`` ((q_block, k_block) pairs forced live, BigBird-style)
    escape; causality always applies. ``block_pattern``: an (nqb, nkb)
    boolean matrix of block-level liveness instead of the window clause
    (exclusive with window/global_prefix/extra_blocks). Every query block
    must keep at least one live key block. ``n`` / ``kn`` must divide by
    ``block_q`` / ``block_k``."""
    kn = n if kn is None else kn
    if n % block_q or kn % block_k:
        raise ValueError(
            f"n ({n}) / kn ({kn}) must divide by block_q ({block_q}) / "
            f"block_k ({block_k})")
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if block_pattern is not None and (window is not None or global_prefix
                                      or len(tuple(extra_blocks))):
        raise ValueError("block_pattern is mutually exclusive with "
                         "window/global_prefix/extra_blocks")
    if (global_prefix or len(tuple(extra_blocks))) and window is None:
        raise ValueError("global_prefix/extra_blocks are escapes from a "
                         "sliding window — pass window too")
    nqb, nkb = n // block_q, kn // block_k
    q0 = np.arange(nqb)[:, None] * block_q
    q1 = q0 + block_q - 1
    k0 = np.arange(nkb)[None, :] * block_k
    k1 = k0 + block_k - 1

    if causal:
        c_live = k0 <= q1
        c_full = k1 <= q0
    else:
        c_live = np.ones((nqb, nkb), bool)
        c_full = c_live

    if block_pattern is not None:
        pat = np.asarray(block_pattern, bool)
        if pat.shape != (nqb, nkb):
            raise ValueError(f"block_pattern shape {pat.shape} != "
                             f"({nqb}, {nkb})")
        live = c_live & pat
        full = c_full & pat
        flag = np.where(full, _FULL, _CAUSAL_ONLY)
    elif window is not None:
        extra = np.zeros((nqb, nkb), bool)
        for qb, kb in extra_blocks:
            extra[qb, kb] = True
        w_live = k1 >= q0 - (window - 1)
        w_full = k0 >= q1 - (window - 1)
        g_live = k0 < global_prefix
        g_full = k1 < global_prefix
        live = c_live & (w_live | g_live | extra)
        full = c_full & (w_full | g_full | extra)
        flag = np.where(full, _FULL, np.where(extra, _CAUSAL_ONLY,
                                              _PARTIAL))
    else:
        live = c_live
        full = c_full
        flag = np.where(full, _FULL, _PARTIAL if causal else _FULL)

    kcnt = live.sum(axis=1).astype(np.int32)
    if (kcnt == 0).any():
        raise ValueError(
            f"query blocks {np.nonzero(kcnt == 0)[0].tolist()} attend no "
            f"key block — every query needs at least one live key")
    return BlockMask(n=n, kn=kn, block_q=block_q, block_k=block_k,
                     causal=causal, window=window,
                     global_prefix=global_prefix,
                     fmap=_flat_runs(live, flag),
                     tmap=_flat_runs(live, flag, by_col=True),
                     kcnt=kcnt, qcnt=live.sum(axis=0).astype(np.int32))


def kept_pairs(mask: BlockMask) -> int:
    """The (query, key) pairs one head keeps under the mask: the exact
    count behind a bound on the kernels' work."""
    total = 0
    for qi, kb, flag in mask.fmap[:, :3].tolist():
        keep = _keep(mask, qi * mask.block_q, [kb], [flag], "cpu")
        total += int(keep.sum())
    return total


# ---------------------------------------------------------------------------
# Checks and the launches.
# ---------------------------------------------------------------------------


def _check(q, k, v, mask: BlockMask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("sparse attention takes (B, H, N, D) tensors")
    b, h, _, d = q.shape
    hkv = k.shape[1]
    if v.shape[1] != hkv or h % hkv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({hkv}), "
                         f"and v must have {hkv}")
    if k.shape[0] != b or v.shape[0] != b or k.shape[3] != d \
            or v.shape[2] != k.shape[2]:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not fit")
    # ku's _check_shapes.
    if q.shape[2] != mask.n or k.shape[2] != mask.kn:
        raise ValueError(
            f"q/k lengths ({q.shape[2]}, {k.shape[2]}) do not match the "
            f"BlockMask ({mask.n}, {mask.kn})")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build(SOURCE, NAME)[0]))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.sparse_fwd_launch, lib.sparse_bwd_dq_launch,
               lib.sparse_bwd_dkv_launch):
        fn.argtypes = [p] * 10 + [i] * 9 + [p, f] + [i] * 5 + [p]
        fn.restype = i
    lib.sparse_error_string.argtypes = [i]
    lib.sparse_error_string.restype = ctypes.c_char_p
    return lib


def _launch(entry, outs, q, k, v, do, lse, delta, mask, softmax_scale):
    """One launch of ``entry``'s kernel: the forward (``do``, ``lse`` and
    ``delta`` None; outs (o, lse)), dq (outs (dq,)) or dk/dv (outs (dk,
    dv)). Shapes are checked before devices and types, so that what the
    kernels refuse is refused the same way on any device."""
    name = entry.__name__
    _check(q, k, v, mask)
    b, h, n, d = q.shape
    hkv, kn, dv = k.shape[1], k.shape[2], v.shape[3]
    if d > 128 or dv > 128:
        raise ValueError(f"{name} takes heads up to 128 wide, got {d} and {dv}")
    if do is not None:
        if do.shape != (b, h, n, dv):
            raise ValueError(f"dO shape {tuple(do.shape)} != {(b, h, n, dv)}")
        for t, what in ((lse, "lse"), (delta, "delta")):
            if t.shape != (b, h, n) or t.dtype != torch.float32 or t.device != q.device:
                raise ValueError(f"{what} must be ({b}, {h}, {n}) float32 on {q.device}, "
                                 f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    _check_cuda(name, q, k, v, *(() if do is None else (do,)))
    if do is not None:
        lse, delta = lse.contiguous(), delta.contiguous()
    route = flash_route(q.dtype, d)
    if route == "mma":
        q, k, v = _mma_rows(q), _mma_rows(k), _mma_rows(v)
        do = None if do is None else _mma_rows(do)
    fmap, tmap, fptr, tptr = mask.arrays(q.device)
    by_key = entry is sparse_bwd_dkv_cuda
    strides = (ctypes.c_longlong * 16)(
        *q.stride(), *k.stride(), *v.stride(),
        *(do.stride() if do is not None else (0,) * 4))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _library()
    err = getattr(lib, name.replace("_cuda", "_launch"))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(do), ptr(lse), ptr(delta),
        outs[0].data_ptr(), ptr(outs[1]) if len(outs) > 1 else None,
        (tmap if by_key else fmap).data_ptr(), (tptr if by_key else fptr).data_ptr(),
        b, h, hkv, n, kn, d, dv, mask.block_q, mask.block_k, strides,
        float(softmax_scale), int(mask.causal), int(mask.window is not None),
        int(mask.window or 0), int(mask.global_prefix), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.sparse_error_string(err).decode()} ({err})")
    entry.launches += 1
    entry.route = route


def sparse_fwd_cuda(q, k, v, mask: BlockMask, softmax_scale: float = 1.0):
    """The forward as one launch of the kernel: (o, lse).

    Takes CUDA tensors on one device, q/k/v all f32 or all bf16 with any
    strides, D and Dv up to 128. bf16 runs on the tensor cores, f32 on the
    CUDA cores (``launches`` counts both; ``route`` names the last one's).
    The tensor-core kernels copy rows 16 bytes at a time: a bf16 tensor that
    is not :func:`_mma_ready` (a stride along the head's width, rows not 16
    bytes apart, a misaligned start) is first copied into a layout that is
    (:func:`_mma_rows`). That is a copy on the card, not the plain version.
    Launches on the current stream and does not synchronise. Raises on
    anything else and if the launch is refused."""
    o = torch.empty(*q.shape[:-1], v.shape[-1], dtype=q.dtype, device=q.device)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    _launch(sparse_fwd_cuda, (o, lse), q, k, v, None, None, None, mask, softmax_scale)
    return o, lse


def sparse_bwd_dq_cuda(q, k, v, do, lse, delta, mask: BlockMask,
                       softmax_scale: float = 1.0):
    """dq (B, H, N, D) in q's dtype as one launch of the dq kernel, from the
    forward's lse and ``delta`` = rowsum(dO·O) (both (B, H, N) f32); dO with
    any strides. The terms of :func:`sparse_fwd_cuda`."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(sparse_bwd_dq_cuda, (dq,), q, k, v, do, lse, delta, mask, softmax_scale)
    return dq


def sparse_bwd_dkv_cuda(q, k, v, do, lse, delta, mask: BlockMask,
                        softmax_scale: float = 1.0):
    """(dk, dv) in the dtypes of k and v as one launch of the dk/dv kernel,
    each summed over the query heads of its KV head's group; 0 for a key
    block no query attends. The terms of :func:`sparse_bwd_dq_cuda`."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch(sparse_bwd_dkv_cuda, (dk, dv), q, k, v, do, lse, delta, mask,
            softmax_scale)
    return dk, dv


sparse_fwd_cuda.launches = sparse_bwd_dq_cuda.launches = sparse_bwd_dkv_cuda.launches = 0
sparse_fwd_cuda.route = sparse_bwd_dq_cuda.route = sparse_bwd_dkv_cuda.route = None


# ---------------------------------------------------------------------------
# The plain versions: one block of the map at a time.
# ---------------------------------------------------------------------------


def _keep(mask: BlockMask, q_start, kbs, flags, device):
    """(block_q, R·block_k) bool: ku's _mask_sparse for the query block at
    ``q_start`` against the key blocks ``kbs`` (R,) with their ``flags``."""
    bq, bk = mask.block_q, mask.block_k
    q_idx = q_start + torch.arange(bq, device=device)[:, None]
    k_idx = (torch.as_tensor(kbs, device=device)[:, None] * bk
             + torch.arange(bk, device=device)).reshape(1, -1)
    flag = torch.as_tensor(flags, device=device).repeat_interleave(bk)[None]
    keep = torch.ones(bq, k_idx.shape[1], dtype=torch.bool, device=device)
    if mask.causal:
        keep = keep & (k_idx <= q_idx)
    if mask.window is not None:
        keep = keep & ((q_idx - k_idx < mask.window) | (k_idx < mask.global_prefix)
                       | (flag == _CAUSAL_ONLY))
    return keep | (flag == _FULL)


def _rows(blocks, width, device):
    """The sequence indices of ``blocks`` (R,) of ``width`` rows, flat."""
    return (torch.as_tensor(blocks, device=device)[:, None] * width
            + torch.arange(width, device=device)).reshape(-1)


def _runs(m, by_col):
    """{block: (partner blocks, flags)} of a flat map, in run order."""
    col = _QI if by_col else _KB
    key = _KB if by_col else _QI
    out = {}
    for row in m.tolist():
        out.setdefault(row[key], ([], []))
        out[row[key]][0].append(row[col])
        out[row[key]][1].append(row[_FLAG])
    return out


def _grouped(x, hkv):
    """(B, H, L, D) → (B, Hkv, G, L, D)."""
    b, h = x.shape[:2]
    return x.reshape(b, hkv, h // hkv, *x.shape[2:])


def sparse_fwd_torch(q, k, v, mask: BlockMask, softmax_scale: float = 1.0):
    """The plain version of :func:`sparse_fwd_cuda`, on any device: for each
    query block, its run's key blocks gathered, scores and masks in f32, p
    rounded to v's dtype before P·V."""
    _check(q, k, v, mask)
    b, h, n, _ = q.shape
    hkv, dv, bq = k.shape[1], v.shape[3], mask.block_q
    o = torch.empty(b, h, n, dv, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, n, dtype=torch.float32 if q.dtype != torch.float64
                      else torch.float64, device=q.device)
    for qb, (kbs, flags) in _runs(mask.fmap, False).items():
        rows = slice(qb * bq, (qb + 1) * bq)
        keys = _rows(kbs, mask.block_k, q.device)
        qg = _grouped(q[:, :, rows], hkv)
        s = torch.einsum("bhgqd,bhkd->bhgqk", _wide(qg),
                         _wide(k[:, :, keys])) * softmax_scale
        keep = _keep(mask, qb * bq, kbs, flags, q.device)
        s = torch.where(keep, s, _NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1).clamp_min(1e-30)
        acc = torch.einsum("bhgqk,bhkd->bhgqd", _wide(p.to(v.dtype)),
                           _wide(v[:, :, keys]))
        none = ~keep.any(dim=-1)  # rows with no live key
        out = torch.where(none[:, None], 0.0, acc / l[..., None])
        o[:, :, rows] = out.reshape(b, h, bq, dv).to(q.dtype)
        lse[:, :, rows] = torch.where(none, _NEG_INF, m[..., 0] + torch.log(l)
                                      ).reshape(b, h, bq).to(lse.dtype)
    return o, lse


def _bwd_block(q, k, v, do, lse, delta, keep, rows, keys, hkv, softmax_scale):
    """(p, ds) in f32 over one slab of pairs, (B, Hkv, G, |rows|, |keys|),
    with p = 0 on masked pairs: a row with no live key has lse = -1e30,
    and exp(s - lse) there would not vanish."""
    qg = _grouped(q[:, :, rows], hkv)
    s = torch.einsum("bhgqd,bhkd->bhgqk", _wide(qg), _wide(k[:, :, keys])) * softmax_scale
    lg = _grouped(lse[:, :, rows], hkv)[..., None]
    p = torch.exp(torch.where(keep, s - lg, -torch.inf))
    dp = torch.einsum("bhgqd,bhkd->bhgqk", _wide(_grouped(do[:, :, rows], hkv)),
                      _wide(v[:, :, keys]))
    return p, p * (dp - _grouped(delta[:, :, rows], hkv)[..., None])


def sparse_bwd_dq_torch(q, k, v, do, lse, delta, mask: BlockMask,
                        softmax_scale: float = 1.0):
    """The plain version of :func:`sparse_bwd_dq_cuda`, on any device: ds
    rounded to k's dtype, dq = scale · ds·K summed in f32."""
    _check(q, k, v, mask)
    b, h, n, d = q.shape
    hkv, bq = k.shape[1], mask.block_q
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for qb, (kbs, flags) in _runs(mask.fmap, False).items():
        rows = slice(qb * bq, (qb + 1) * bq)
        keys = _rows(kbs, mask.block_k, q.device)
        keep = _keep(mask, qb * bq, kbs, flags, q.device)
        _, ds = _bwd_block(q, k, v, do, lse, delta, keep, rows, keys, hkv, softmax_scale)
        g = torch.einsum("bhgqk,bhkd->bhgqd", _wide(ds.to(k.dtype)), _wide(k[:, :, keys]))
        dq[:, :, rows] = (softmax_scale * g).reshape(b, h, bq, d).to(q.dtype)
    return dq


def sparse_bwd_dkv_torch(q, k, v, do, lse, delta, mask: BlockMask,
                         softmax_scale: float = 1.0):
    """The plain version of :func:`sparse_bwd_dkv_cuda`, on any device: for
    each key block, its run's query blocks gathered; p rounded to dO's
    dtype, dv = pᵀ·dO; ds rounded to q's dtype, dk = scale · dsᵀ·Q; each
    summed in f32 over the query heads of a group and rounded once. A key
    block with an empty run gets zeros."""
    _check(q, k, v, mask)
    hkv, bk = k.shape[1], mask.block_k
    dk = torch.zeros(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.zeros(v.shape, dtype=v.dtype, device=v.device)
    for kb, (qbs, flags) in _runs(mask.tmap, True).items():
        cols = slice(kb * bk, (kb + 1) * bk)
        rows = _rows(qbs, mask.block_q, q.device)
        # The (R·block_q, block_k) mask: each query block against this key
        # block, stacked.
        keep = torch.cat([_keep(mask, qb * mask.block_q, [kb], [f], q.device)
                          for qb, f in zip(qbs, flags)])
        keys = torch.arange(kb * bk, (kb + 1) * bk, device=q.device)
        p, ds = _bwd_block(q, k, v, do, lse, delta, keep, rows, keys, hkv, softmax_scale)
        dv[:, :, cols] = torch.einsum(
            "bhgqk,bhgqd->bhkd", _wide(p.to(do.dtype)),
            _wide(_grouped(do[:, :, rows], hkv))).to(v.dtype)
        dk[:, :, cols] = (softmax_scale * torch.einsum(
            "bhgqk,bhgqd->bhkd", _wide(ds.to(q.dtype)),
            _wide(_grouped(q[:, :, rows], hkv)))).to(k.dtype)
    return dk, dv


# ---------------------------------------------------------------------------
# Dispatch and autograd.
# ---------------------------------------------------------------------------


def sparse_fwd(q, k, v, mask: BlockMask, softmax_scale: float = 1.0):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return sparse_fwd_cuda(q, k, v, mask, softmax_scale)
    if q.device.type == "cpu":
        return sparse_fwd_torch(q, k, v, mask, softmax_scale)
    raise ValueError(f"no sparse attention for device {q.device}")


def sparse_bwd_cuda(q, k, v, o, lse, do, mask: BlockMask, softmax_scale: float = 1.0):
    """(dq, dk, dv) through the two backward kernels, from the forward's
    (o, lse) and the output's gradient ``do`` (any strides)."""
    delta = _delta(o, do)
    dq = sparse_bwd_dq_cuda(q, k, v, do, lse, delta, mask, softmax_scale)
    return (dq,) + sparse_bwd_dkv_cuda(q, k, v, do, lse, delta, mask, softmax_scale)


def sparse_bwd_torch(q, k, v, o, lse, do, mask: BlockMask, softmax_scale: float = 1.0):
    """The plain version of :func:`sparse_bwd_cuda`, on any device."""
    delta = _delta(o, do)
    dq = sparse_bwd_dq_torch(q, k, v, do, lse, delta, mask, softmax_scale)
    return (dq,) + sparse_bwd_dkv_torch(q, k, v, do, lse, delta, mask, softmax_scale)


def sparse_bwd(q, k, v, o, lse, do, mask: BlockMask, softmax_scale: float = 1.0):
    """The kernels for CUDA tensors, the plain versions for CPU tensors."""
    if q.device.type == "cuda":
        return sparse_bwd_cuda(q, k, v, o, lse, do, mask, softmax_scale)
    if q.device.type == "cpu":
        return sparse_bwd_torch(q, k, v, o, lse, do, mask, softmax_scale)
    raise ValueError(f"no sparse attention for device {q.device}")


class SparseAttention(torch.autograd.Function):
    """o = block-sparse attention of (q, k, v) under ``mask``,
    differentiable in q, k and v: forward :func:`sparse_fwd`, backward
    :func:`sparse_bwd` from the saved q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, mask, softmax_scale):
        o, lse = sparse_fwd(q, k, v, mask, softmax_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask, ctx.softmax_scale = mask, softmax_scale
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = sparse_bwd(q, k, v, o, lse, do, ctx.mask, ctx.softmax_scale)
        return dq, dk, dv, None, None


def sparse_attention(q, k, v, mask: BlockMask, softmax_scale: float = 1.0):
    """Block-sparse flash attention over a static :class:`BlockMask`
    pattern, as ``ku``'s: the output (B, H, N, Dv). Through
    :class:`SparseAttention` when gradients are wanted for q, k or v, else
    :func:`sparse_fwd`'s output alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return SparseAttention.apply(q, k, v, mask, softmax_scale)
    return sparse_fwd(q, k, v, mask, softmax_scale)[0]
