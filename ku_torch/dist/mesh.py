"""Device meshes, sharding and the data-parallel CD epoch, over
``torch.distributed``.

Port of ``ku/dist/mesh.py``. ``ku`` runs one program over a
``jax.sharding.Mesh`` of every device and lets ``shard_map``, ``psum`` and
GSPMD split the work; the port is SPMD in
PyTorch's idiom instead: one process per GPU, each holding its own device,
a ``torch.distributed.device_mesh.DeviceMesh`` over the processes, and
collectives over its process group (NCCL on the card, gloo on the CPU).

- :func:`initialize_multihost` starts the process group (the caller gives
  its address or store, world size and rank; nothing is discovered).
- :func:`make_mesh` builds the mesh; with no process group started it starts
  a world of one process on this device, so a one-card caller needs nothing
  else.
- :func:`shard_batch` is this rank's slice of each tensor.
- Sharding: ``ku``'s ``NamedSharding(mesh, P(...))`` is a
  :class:`NamedSharding` here, a mesh and a ``PartitionSpec``-like tuple
  (one entry per tensor dimension: a mesh dimension's name or None), whose
  :attr:`NamedSharding.placements` are ``torch.distributed.tensor``'s
  ``Shard(d)`` / ``Replicate()``, one per mesh dimension. :func:`place`
  puts a tensor on the mesh by it (``distribute_tensor``, a ``DTensor``;
  ``.to_local()`` is this rank's slice) and :func:`local_slice` cuts this
  rank's slice without communication. :func:`data_parallel_sharding`,
  :func:`replicate`, :func:`shard_gan_state`, :func:`shard_decode_state` and
  :func:`shard_stacked_batches` are ``ku``'s helpers. Their decisions are
  the plain functions :func:`gan_leaf_spec`, :func:`decode_param_spec`,
  :func:`decode_cache_spec` and :func:`decode_heads_divide`, of the mesh's
  axis sizes, a leaf's '/'-joined path and its shape: so they can be held
  against ``ku``'s on meshes that one process cannot build.
- :func:`cd_epoch_dp` is ``ku``'s scan-plus-psum epoch: each step the
  rank's rows through :func:`ku_torch.ebm.rbm.cd_stats`, an all-reduce of
  the statistics, :func:`ku_torch.ebm.rbm.apply_stats`.

The layers' own collectives (head-parallel serving, the GAN engine's
splits) are :mod:`ku_torch.dist.parallel`. The fused data-parallel run, whose steps are hand-written kernels, is
:func:`ku_torch.kernels.cd_gibbs_dp.cd_train_dp`.
"""

from __future__ import annotations

import warnings
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def initialize_multihost(**kwargs) -> None:
    """Start the default process group: ``torch.distributed.
    init_process_group(**kwargs)``. Call it in every process, with its
    ``rank``, the ``world_size`` and an ``init_method`` (such as
    ``"tcp://localhost:29500"``) or a ``store``, before :func:`make_mesh`."""
    dist.init_process_group(**kwargs)


def _device_type(devices) -> str:
    """The device type that ``devices`` (None, a device, or a list of them,
    all of one type) names."""
    if devices is None:
        if dist.is_initialized():
            return "cuda" if dist.get_backend() == "nccl" else "cpu"
        return "cuda"
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    types = {torch.device(d).type for d in devices}
    if len(types) != 1:
        raise ValueError(f"a mesh holds devices of one type, got {sorted(types)}")
    return types.pop()


def make_mesh(axis_shapes: Optional[dict] = None, devices=None) -> DeviceMesh:
    """A mesh over the processes of the world; by default one ``"data"``
    dimension over all of them.

    ``make_mesh({"data": 4, "model": 2})`` builds a 2-D mesh over the first
    eight processes. ``devices`` names the device type, as a device or a list
    of devices: ``"cuda"`` (the default, NCCL) or ``"cpu"`` (gloo); with a
    process group already started, the default follows its backend.

    If no process group has been started, this starts a world of one
    process on this device, through an in-process ``HashStore`` (no
    network): on the current CUDA device with NCCL, or on the CPU with gloo.
    Raises ``ValueError`` if the mesh needs more processes than the world
    has, and ``RuntimeError`` for a CUDA mesh without a CUDA device.
    """
    device_type = _device_type(devices)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not axis_shapes:
        axis_shapes = {"data": world}
    names = tuple(axis_shapes)
    shape = tuple(int(axis_shapes[n]) for n in names)
    n_needed = int(np.prod(shape))
    if n_needed > world:
        raise ValueError(f"mesh needs {n_needed} devices, have {world}")
    if not dist.is_initialized():
        if device_type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("a CUDA mesh needs a CUDA device; pass "
                                   "devices='cpu' for a mesh on the CPU")
            dist.init_process_group(
                "nccl", store=dist.HashStore(), rank=0, world_size=1,
                device_id=torch.device("cuda", torch.cuda.current_device()))
        else:
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                    world_size=1)
    return DeviceMesh(device_type, torch.arange(n_needed).reshape(shape),
                      mesh_dim_names=names)


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` itself; ``TypeError`` for anything but a ``DeviceMesh``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (ku_torch.dist.make_mesh), "
                        f"got {type(mesh).__name__}")
    return mesh


def axis_info(mesh: DeviceMesh, axis_name: str = "data"):
    """(process group, its size, this process's rank in it) of one mesh
    dimension. Raises ``TypeError`` for anything but a ``DeviceMesh``."""
    check_mesh(mesh)
    group = mesh.get_group(axis_name)
    return group, dist.get_world_size(group), dist.get_rank(group)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: DeviceMesh, tree, axis: int = 0, axis_name: str = "data"):
    """This rank's slice of every tensor of ``tree`` (a tensor, or dicts,
    lists and tuples of them): dimension ``axis`` cut into as many equal
    parts as the mesh's ``axis_name`` dimension has ranks, and part ``rank``
    kept. A view where slicing gives one. Raises ``ValueError`` if a
    dimension does not divide."""
    _, world, rank = axis_info(mesh, axis_name)

    def take(x):
        n = x.shape[axis]
        if n % world:
            raise ValueError(f"dimension {axis} of size {n} does not divide "
                             f"over {world} ranks")
        part = n // world
        return x.narrow(axis, rank * part, part)

    return _tree_map(take, tree)


# -- sharding ---------------------------------------------------------------


def axis_sizes(mesh: DeviceMesh) -> dict:
    """{dimension name: size} of a mesh (``ku``'s ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


class NamedSharding:
    """``ku``'s ``NamedSharding(mesh, P(*spec))``: ``spec`` names, for each
    leading dimension of a tensor, the mesh dimension it is split over (or
    None); ``()`` replicates. :attr:`placements` is the same placement in
    ``torch.distributed.tensor``'s terms, one per mesh dimension."""

    def __init__(self, mesh: DeviceMesh, spec: Sequence = ()):
        self.mesh, self.spec = mesh, tuple(spec)
        named = [a for a in self.spec if a is not None]
        unknown = set(named) - set(mesh.mesh_dim_names)
        if unknown or len(named) != len(set(named)):
            raise ValueError(f"spec {self.spec} does not fit the mesh's dimensions "
                             f"{mesh.mesh_dim_names}")

    @property
    def placements(self) -> list:
        from torch.distributed.tensor import Replicate, Shard

        return [Shard(self.spec.index(name)) if name in self.spec else Replicate()
                for name in self.mesh.mesh_dim_names]

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.mesh_dim_names}, {self.spec})"


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place(x, sharding: NamedSharding):
    """``x`` (a tensor or an array) on the mesh by ``sharding``: a ``DTensor``
    from ``torch.distributed.tensor.distribute_tensor`` (every rank passes
    the same whole ``x``), whose ``.to_local()`` is this rank's slice."""
    from torch.distributed.tensor import distribute_tensor

    x = torch.as_tensor(x).to(_mesh_device(sharding.mesh))
    return distribute_tensor(x, sharding.mesh, sharding.placements)


def local_slice(x, sharding: NamedSharding):
    """This rank's slice of the whole ``x`` under ``sharding``, cut without
    communication (a view). Raises ``ValueError`` if a split dimension does
    not divide."""
    sizes = axis_sizes(sharding.mesh)
    coord = dict(zip(sharding.mesh.mesh_dim_names, sharding.mesh.get_coordinate()))
    for dim, name in enumerate(sharding.spec):
        if name is None:
            continue
        n, w = x.shape[dim], sizes[name]
        if n % w:
            raise ValueError(f"dimension {dim} of size {n} does not divide over "
                             f"the {w} ranks of {name!r}")
        x = x.narrow(dim, coord[name] * (n // w), n // w)
    return x


def _tree_map_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over dicts, lists and tuples; paths '/'-joined."""
    if isinstance(tree, Mapping):
        return {k: _tree_map_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_path(fn, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def data_parallel_sharding(mesh: DeviceMesh, ndim: int, axis: int = 0,
                           axis_name: str = "data") -> NamedSharding:
    """Dimension ``axis`` of an ``ndim``-dimensional tensor split over
    ``axis_name``."""
    spec = [None] * ndim
    spec[axis] = axis_name
    return NamedSharding(mesh, spec)


def replicate(mesh: DeviceMesh) -> NamedSharding:
    """The whole tensor on every rank."""
    return NamedSharding(mesh, ())


GAN_TP_PATTERNS = ("map_dense", "style_dense", "dense_1")


def gan_leaf_spec(path: str, shape, sizes: Mapping, model_axis: str = "model",
                  tp_patterns: Sequence[str] = GAN_TP_PATTERNS) -> tuple:
    """``ku``'s placement of one GAN state leaf: a 2-D ``kernel`` whose path
    holds one of ``tp_patterns`` and whose columns divide ``model_axis`` is
    split by column, ``(None, model_axis)``; anything else is replicated."""
    if (len(shape) == 2 and "kernel" in path
            and any(pat in path for pat in tp_patterns)
            and model_axis in sizes and shape[1] % sizes[model_axis] == 0):
        return (None, model_axis)
    return ()


def shard_gan_state(state, mesh: DeviceMesh, model_axis: str = "model",
                    tp_patterns: Sequence[str] = GAN_TP_PATTERNS):
    """A GAN state (nested dicts, lists and tuples of tensors or arrays, such
    as :func:`ku_torch.backprop.state_to_ku`'s) placed on the mesh by
    :func:`gan_leaf_spec`: ``DTensor`` leaves; other leaves as they are."""
    sizes = axis_sizes(mesh)

    def put(path, leaf):
        if not _is_array(leaf):
            return leaf
        spec = gan_leaf_spec(path, tuple(leaf.shape), sizes, model_axis, tp_patterns)
        return place(leaf, NamedSharding(mesh, spec))

    return _tree_map_path(put, state)


def decode_heads_divide(tp: int, num_head: Optional[int] = None,
                        num_kv_head: Optional[int] = None) -> bool:
    """Whether head-parallel serving can split the heads over ``tp`` ranks:
    True without a ``num_head`` to check (``ku`` then trusts the shapes)."""
    if num_head is None:
        return True
    hkv = num_kv_head if num_kv_head is not None else num_head
    return not (num_head % tp or hkv % tp)


def decode_param_spec(path: str, shape, tp: int, model_axis: str = "model") -> tuple:
    """``ku``'s head-parallel placement of one transformer parameter (when
    the heads divide): ``W_Q`` / ``W_K`` / ``W_V`` and ``Dense_0/kernel`` by
    column, ``W_multi_head`` and ``Dense_1/kernel`` by row, ``Dense_0/bias``
    split; each only where its dimension divides ``tp``, else replicated."""
    if len(shape) == 2:
        if path.endswith(("W_Q", "W_K", "W_V")) or "Dense_0/kernel" in path:
            if shape[1] % tp == 0:
                return (None, model_axis)
        elif path.endswith("W_multi_head") or "Dense_1/kernel" in path:
            if shape[0] % tp == 0:
                return (model_axis, None)
    if len(shape) == 1 and "Dense_0/bias" in path and shape[0] % tp == 0:
        return (model_axis,)
    return ()


_POOL_LEAVES = ("pages_k", "pages_v", "key_scale_pages", "value_scale_pages")


def decode_cache_spec(name: str, shape, tp: int, model_axis: str = "model",
                      data_axis: Optional[str] = None, heads: bool = True) -> tuple:
    """``ku``'s placement of one KV-cache leaf (``name`` its last path entry):
    the head axis (1) of the dense, paged and int8 entries over
    ``model_axis`` where it divides; the batch axis (0) of every per-row leaf
    over ``data_axis``, never a page pool's (its axis 0 is pages). With
    ``heads=False`` (the heads do not divide) only the batch axis splits."""
    nd = len(shape)
    if not heads:
        if name in _POOL_LEAVES:
            return ()
        return (data_axis,) if data_axis is not None and nd >= 1 else ()
    if name in ("cached_key", "cached_value") and nd == 4 and shape[1] % tp == 0:
        return (data_axis, model_axis, None, None)
    if name in ("key_scale", "value_scale") and nd == 3 and shape[1] % tp == 0:
        return (data_axis, model_axis, None)
    if name in ("pages_k", "pages_v") and nd == 4:
        return (None, model_axis, None, None) if shape[1] % tp == 0 else ()
    if name in ("key_scale_pages", "value_scale_pages") and nd == 3:
        return (None, model_axis, None) if shape[1] % tp == 0 else ()
    if data_axis is not None and nd >= 1:
        return (data_axis,)  # cache_index (B,), page_table / cache_pos (B, m)
    return ()


def decode_fallback_warning(num_head, num_kv_head, tp) -> None:
    hkv = num_kv_head if num_kv_head is not None else num_head
    warnings.warn(
        f"shard_decode_state: num_head={num_head}/num_kv_head={hkv} do not "
        f"divide tp={tp} — placing weights and cache heads replicated "
        "(head-parallel serving needs head counts divisible by the model "
        "axis)", stacklevel=3)


def shard_decode_state(params, cache, mesh: DeviceMesh, model_axis: str = "model",
                       num_head: Optional[int] = None,
                       num_kv_head: Optional[int] = None,
                       data_axis: Optional[str] = None):
    """Head-parallel serving's placement of a transformer stack's parameters
    (a state dict, '.'- or '/'-joined names, or nested dicts) and KV cache
    (the cache protocol's '/'-keyed dict), as ``ku``'s: each leaf placed by
    :func:`decode_param_spec` / :func:`decode_cache_spec`. When ``num_head``
    (and ``num_kv_head``) do not divide the model axis it warns and
    replicates the parameters and the cache's heads, keeping the batch split
    over ``data_axis``. Returns (params, cache) with ``DTensor`` leaves."""
    tp = axis_sizes(mesh)[model_axis]
    heads = decode_heads_divide(tp, num_head, num_kv_head)
    if not heads:
        decode_fallback_warning(num_head, num_kv_head, tp)

    def put_param(path, leaf):
        path = path.replace(".", "/")
        spec = decode_param_spec(path, tuple(leaf.shape), tp, model_axis) if heads else ()
        return place(leaf, NamedSharding(mesh, spec))

    def put_cache(path, leaf):
        name = path.rsplit("/", 1)[-1]
        spec = decode_cache_spec(name, tuple(leaf.shape), tp, model_axis, data_axis, heads)
        return place(leaf, NamedSharding(mesh, spec))

    return _tree_map_path(put_param, params), _tree_map_path(put_cache, cache)


def shard_stacked_batches(batches, mesh: DeviceMesh, axis_name: str = "data",
                          batch_axis: int = 1):
    """The GAN engine's stacked batches on the mesh, the batch dimension
    split over ``axis_name``: ``batch_axis`` 1 for (k, batch, ...) stacks, 2
    for the multi-step (S, k, batch, ...) stacks. ``DTensor`` leaves."""
    spec = [None] * batch_axis + [axis_name]
    return _tree_map_path(lambda _, x: place(x, NamedSharding(mesh, spec)), batches)


def _rank_generator(generator: torch.Generator, rank: int,
                   device=None) -> torch.Generator:
    """A generator for ``rank``, drawn from ``generator`` (the same on every
    rank) and decorrelated by the rank, as ``ku`` folds the axis index into
    its key (``jax.random.fold_in``)."""
    root = int(torch.randint(0, 2**63 - 1, (), generator=generator))
    words = np.random.SeedSequence([root, int(rank)]).generate_state(2, np.uint64)
    g = torch.Generator(device=torch.device(device or generator.device))
    g.manual_seed(int(words[0]) & (2**63 - 1))
    return g


def cd_epoch_dp(mesh: DeviceMesh, params, v_all, mask, generator, lr: float,
                k: int, mode: int, batch_size: int):
    """Data-parallel CD epoch: each batch's rows split over the mesh's
    ``"data"`` ranks, the CD statistics all-reduced each step, the
    parameters the same on every rank.

    Every rank passes the whole padded ``v_all`` (steps·batch_size, V) and
    its ``mask``, and the same ``params`` and ``generator``; it trains on
    rows ``rank·lb .. (rank+1)·lb - 1`` of each batch (lb = batch_size /
    world), moved to the parameters' device, with a generator decorrelated
    by rank. Returns (params, per-step scores). Raises ``ValueError`` if
    ``batch_size`` does not divide over the ranks (``ku`` asserts).
    """
    from ku_torch.ebm.rbm import apply_stats, cd_stats

    group, world, rank = axis_info(mesh)
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} does not divide over "
                         f"{world} ranks of the data axis")
    steps = v_all.shape[0] // batch_size
    lb = batch_size // world
    device = params["rbm_weight"].device
    v_local = shard_batch(mesh, v_all.reshape(steps, world, lb, -1), axis=1)
    m_local = shard_batch(mesh, mask.reshape(steps, world, lb), axis=1)
    v_local, m_local = v_local.to(device), m_local.to(device)
    g = _rank_generator(generator, rank, device)
    names = ("d_w", "d_bh", "d_bv", "score_sum", "count")
    scores = torch.empty(steps, dtype=v_local.dtype, device=device)
    for s in range(steps):
        stats = cd_stats(params, v_local[s, 0], g, k, mode, weight=m_local[s, 0])
        flat = torch.cat([stats[n].reshape(-1) for n in names])
        dist.all_reduce(flat, group=group)
        sizes = [stats[n].numel() for n in names]
        stats = {n: part.view_as(stats[n])
                 for n, part in zip(names, flat.split(sizes))}
        params = apply_stats(params, stats, lr)
        scores[s] = stats["score_sum"] / stats["count"].clamp_min(1.0)
    return params, scores
