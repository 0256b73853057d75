"""Tensor and data parallelism inside the layers: the differentiable
collectives, the layers' parallel descriptor, and the in-place splitting of
a model's parameters over a mesh dimension.

``ku`` places parameters with ``NamedSharding`` and lets GSPMD insert the
collectives; the port, one process per device, places them as this rank's
slices (:func:`ku_torch.dist.mesh.local_slice`) and its layers call the
collectives themselves, Megatron's way:

- a column-split matmul takes its input through :func:`copy_to` (identity
  forward, gradient summed over the group) and, where the features are
  wanted whole, all-gathers them (:func:`gather_last`, backward: this
  rank's slice of the replicated gradient);
- a row-split matmul closes with :func:`reduce_sum` (all-reduce forward,
  identity backward), before the bias;
- statistics over a data-split batch use :func:`all_reduce_sum` (gradient
  summed over the group) and :func:`gather_rows` (all-gather along the
  batch, backward the summed gradient of this rank's rows).

Over a group of one rank each collective is the identity and none is
issued (NCCL at one rank cost ~0.25 ms of host time a call, 0.53x the
plain batcher's decode tokens/s on an H100, PERF.md).

A layer takes part through its ``parallel`` attribute, a
:class:`TensorParallel` (None by default: the layer computes alone):
``Dense``-like layers by its ``mode`` (``"column"``, ``"gather"`` or
``"row"``, :func:`parallel_matmul`), ``MultiHeadAttention`` over its rank's
heads. :func:`shard_heads_` splits a transformer stack for head-parallel
serving; :func:`shard_columns_` splits a GAN's kernels by column.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from ku_torch.dist.mesh import (
    GAN_TP_PATTERNS,
    NamedSharding,
    axis_sizes,
    decode_fallback_warning,
    decode_heads_divide,
    decode_param_spec,
    gan_leaf_spec,
    local_slice,
)


# Each collective's backward is its adjoint collective, itself an autograd
# function, so that gradients of gradients (R1, WGAN-GP) pass through them.


def _all_reduce(x, group):
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def _all_gather_cat(x, group, dim):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _own(x, group, dim, width):
    return x.narrow(dim, dist.get_rank(group) * width, width).contiguous()


class _CopyTo(torch.autograd.Function):
    """Identity; backward all-reduces (the adjoint of :class:`_ReduceSum`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ReduceSum.apply(g, ctx.group), None


class _ReduceSum(torch.autograd.Function):
    """All-reduce; backward passes the gradient (the adjoint of
    :class:`_CopyTo`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _CopyTo.apply(g, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    """All-reduce, and all-reduce backward (self-adjoint)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


class _GatherLast(torch.autograd.Function):
    """All-gather along the last dimension; backward keeps this rank's
    columns (the adjoint of :class:`_SplitLast`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return _all_gather_cat(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        return _SplitLast.apply(g, ctx.group, ctx.width), None


class _SplitLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, width):
        ctx.group = group
        return _own(x, group, x.dim() - 1, width)

    @staticmethod
    def backward(ctx, g):
        return _GatherLast.apply(g, ctx.group), None, None


class _GatherRows(torch.autograd.Function):
    """All-gather along dimension 0; backward sums the ranks' gradients and
    keeps this rank's rows (the adjoint of :class:`_ReduceScatterRows`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _all_gather_cat(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatterRows.apply(g, ctx.group, ctx.rows), None


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rows):
        ctx.group = group
        return _own(_all_reduce(x, group), group, 0, rows)

    @staticmethod
    def backward(ctx, g):
        return _GatherRows.apply(g, ctx.group), None, None


# Over a group of one rank each of these is the identity, forward and
# backward, and issues nothing.


def _alone(group) -> bool:
    return group.size() == 1


def copy_to(x, group):
    """x as it is; its gradient summed over ``group`` (the input of a
    column-split matmul, whose ranks each see part of the output)."""
    return x if _alone(group) else _CopyTo.apply(x, group)


def reduce_sum(x, group):
    """x summed over ``group`` (a row-split matmul's partial products); the
    gradient passes as it is."""
    return x if _alone(group) else _ReduceSum.apply(x, group)


def all_reduce_sum(x, group):
    """x summed over ``group``, the gradient summed too: a statistic of a
    batch split over the group, under a loss that each rank holds a part
    of."""
    return x if _alone(group) else _AllReduceSum.apply(x, group)


def gather_last(x, group):
    """The ranks' x concatenated along the last dimension (a column-split
    matmul's features); backward keeps this rank's columns of the
    (replicated) gradient."""
    return x if _alone(group) else _GatherLast.apply(x, group)


def gather_rows(x, group):
    """The ranks' x concatenated along dimension 0 (a data-split batch);
    backward sums the ranks' gradients and keeps this rank's rows."""
    return x if _alone(group) else _GatherRows.apply(x, group)


_DATA_GROUP = None


@contextlib.contextmanager
def data_parallel(group):
    """Within the body, the layers that take statistics over the batch
    (``TruncationTrick``'s batch mean, ``MinibatchStddevConcat``'s groups)
    take them over the whole batch that ``group``'s ranks split between
    them, as ``ku`` does over a data-sharded batch (None: this rank's rows
    alone)."""
    global _DATA_GROUP
    prev, _DATA_GROUP = _DATA_GROUP, group
    try:
        yield
    finally:
        _DATA_GROUP = prev


def data_group():
    """The process group of :func:`data_parallel`'s body, or None."""
    return _DATA_GROUP


class TensorParallel:
    """A layer's part in a split over one mesh dimension's process group:
    ``world`` ranks, this one ``rank``; ``mode`` for ``Dense``-like layers
    (:func:`parallel_matmul`)."""

    def __init__(self, group, mode: Optional[str] = None):
        if mode not in (None, "column", "gather", "row"):
            raise ValueError(f"mode must be 'column', 'gather' or 'row', got {mode!r}")
        self.group, self.mode = group, mode
        self.world, self.rank = dist.get_world_size(group), dist.get_rank(group)

    def __repr__(self) -> str:
        return f"TensorParallel(world={self.world}, rank={self.rank}, mode={self.mode!r})"


def parallel_matmul(layer, x, w):
    """``x @ w`` as ``layer.parallel`` splits it: alone (None); ``"column"``
    (w holds this rank's columns, the output stays split); ``"gather"`` (the
    columns all-gathered); ``"row"`` (w holds this rank's rows and x its
    columns, the partial products summed). The bias comes after, whole
    (split too in ``"column"``)."""
    p = getattr(layer, "parallel", None)
    if p is None or p.world == 1:
        return x @ w
    if p.mode != "row":
        x = copy_to(x, p.group)
    y = x @ w
    if p.mode == "gather":
        return gather_last(y, p.group)
    if p.mode == "row":
        return reduce_sum(y, p.group)
    return y


def _owner(model, name):
    """(module, attribute) owning the parameter ``name`` of ``model``."""
    path, _, attr = name.rpartition(".")
    return (model.get_submodule(path) if path else model), attr


def shard_heads_(model, mesh, model_axis: str = "model", num_head: Optional[int] = None,
                 num_kv_head: Optional[int] = None) -> bool:
    """Split ``model``'s attention and FFN over ``model_axis`` in place, for
    head-parallel serving: each parameter that
    :func:`ku_torch.dist.mesh.decode_param_spec` splits becomes this rank's
    slice (``W_Q`` / ``W_K`` / ``W_V`` its heads' columns, ``W_multi_head``
    their rows, ``Dense_0`` its columns and bias, ``Dense_1`` its rows), and
    each ``MultiHeadAttention`` computes its rank's heads and each FFN pair
    its slice, closed by an all-reduce. The caches the layers then create
    hold the rank's heads. When the head counts (the given ones, or any
    attention layer's) do not divide the model axis it warns, as ``ku``
    does, and leaves the model whole. Returns whether it split. Refuses
    int8 weights (``quant_weights``) past a model axis of 1."""
    from ku_torch.nn.attention import MultiHeadAttention  # (it imports this module)

    tp = axis_sizes(mesh)[model_axis]
    mhas = [m for m in model.modules() if isinstance(m, MultiHeadAttention)]
    if tp > 1 and any(m.quant_weights for m in mhas):
        raise ValueError("head-parallel serving of int8 weights (quant_weights) is not "
                         "supported: serve the float model over the mesh")
    heads = decode_heads_divide(tp, num_head, num_kv_head) and all(
        decode_heads_divide(tp, m.num_head, m.num_kv_head) for m in mhas)
    if not heads:
        decode_fallback_warning(num_head if num_head is not None else mhas[0].num_head,
                                num_kv_head, tp)
        return False
    group = mesh.get_group(model_axis)
    modes = {}
    for name, p in model.named_parameters():
        path = name.replace(".", "/")
        spec = decode_param_spec(path, tuple(p.shape), tp, model_axis)
        if not spec:
            continue
        p.data = local_slice(p.data, NamedSharding(mesh, spec)).clone()
        module, attr = _owner(model, name)
        if attr == "kernel":
            modes[module] = "column" if spec == (None, model_axis) else "row"
    for m in mhas:
        m.parallel = TensorParallel(group)
    for module, mode in modes.items():
        module.parallel = TensorParallel(group, mode)
    return True


def shard_columns_(module, mesh, model_axis: str = "model") -> list:
    """Split, in place, each 2-D ``kernel`` of ``module`` that
    :func:`ku_torch.dist.mesh.gan_leaf_spec` splits by column (``ku``'s
    ``shard_gan_state``): the parameter (the same object) holds this rank's
    columns and its layer computes them, then all-gathers the features
    (``"gather"``); the bias stays whole. Returns (parameter, cut) for each
    kernel split, ``cut`` taking this rank's columns of a tensor of the
    kernel's whole shape (its optimizer moments)."""
    sizes = axis_sizes(mesh)
    group = mesh.get_group(model_axis)
    split = []
    for name, p in module.named_parameters():
        spec = gan_leaf_spec(name.replace(".", "/"), tuple(p.shape), sizes, model_axis,
                             GAN_TP_PATTERNS)
        if not spec:
            continue
        sharding = NamedSharding(mesh, spec)
        cut = lambda t, s=sharding: local_slice(t, s).clone()  # noqa: E731
        p.data = cut(p.data)
        _owner(module, name)[0].parallel = TensorParallel(group, "gather")
        split.append((p, cut))
    return split
