"""Device meshes and the data-parallel CD epoch, over ``torch.distributed``.

Port of the part of ``ku/dist/mesh.py`` that data-parallel RBM training
needs. ``ku`` runs one program over a ``jax.sharding.Mesh`` of every device
and lets ``shard_map`` and ``psum`` split the work; the port is SPMD in
PyTorch's idiom instead: one process per GPU, each holding its own device,
a ``torch.distributed.device_mesh.DeviceMesh`` over the processes, and
collectives over its process group (NCCL on the card, gloo on the CPU).

- :func:`initialize_multihost` starts the process group (the caller gives
  its address or store, world size and rank; nothing is discovered).
- :func:`make_mesh` builds the mesh; with no process group started it starts
  a world of one process on this device, so a one-card caller needs nothing
  else.
- :func:`shard_batch` is this rank's slice of each tensor.
- :func:`cd_epoch_dp` is ``ku``'s scan-plus-psum epoch: each step the
  rank's rows through :func:`ku_torch.ebm.rbm.cd_stats`, an all-reduce of
  the statistics, :func:`ku_torch.ebm.rbm.apply_stats`.

The fused data-parallel run, whose steps are hand-written kernels, is
:func:`ku_torch.kernels.cd_gibbs_dp.cd_train_dp`.
"""

from __future__ import annotations

from typing import Optional

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


def axis_info(mesh: DeviceMesh, axis_name: str = "data"):
    """(process group, its size, this process's rank in it) of one mesh
    dimension. Raises ``TypeError`` for anything but a ``DeviceMesh``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (ku_torch.dist.make_mesh), "
                        f"got {type(mesh).__name__}")
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
