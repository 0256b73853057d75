"""Data-parallel CD-k training: two CUDA step kernels with an all-reduce
between them, and their plain versions.

Port of ``ku/pallas/cd_gibbs.py``'s data-parallel part. The kernels,
``ku_torch/csrc/cd_gibbs_dp.cu``, replace ``ku/pallas/cd_gibbs.py::
_make_dp_kernel``, whose in-kernel RDMA ring sums each step's CD statistics
over the devices. Here each rank (one process per GPU) takes a step as

- (a) :func:`cd_dp_stats_cuda`: the CD-k step of kernel #1 over the rank's
  rows of the step, on kernel #1's two routes (the shared step code of
  ``cd_cluster.cuh`` on one thread-block cluster that loads W into its
  shared memory, or ``cd_grid.cuh`` on a cooperative grid; chosen by
  the shape, :func:`ku_torch.kernels.cd_gibbs.route_for`, and reported by
  :func:`last_launch`), its sums over those rows packed into one buffer of
  V·H + H + V + 2 floats (:func:`payload_size`): the W sums, the b_h sums,
  the b_v sums, Σ|ΔF| and Σmask;
- (b) ``torch.distributed.all_reduce`` of the buffer over the mesh's
  ``"data"`` group (NCCL on the card);
- (c) :func:`cd_dp_apply_cuda`: W += lr·ΣW, the biases likewise, and the
  step's score Σ|ΔF| / max(Σmask, 1).

Two launches and one all-reduce a step, queued on the current stream with
no host synchronisation inside the run. The source note gives the bound of
a rank's step on an H100 and what the design does about it.

A rank's rows of step s are rows ``rank·lb .. (rank+1)·lb - 1`` of the
step's global batch (lb = batch_size / world), and its Philox counter runs
at those global rows, so the ranks together draw exactly the numbers a
single-device run (:mod:`ku_torch.kernels.cd_gibbs`) draws, at any world
size; at world size 1 the run equals kernel #1's bit for bit. ``ku`` seeds
each device apart instead (``seed + step·n_dev + my_id``): the TPU's PRNG
and Philox give different bits anyway, so the distribution is the same and
the streams are not.

- :func:`cd_dp_stats_torch` and :func:`cd_dp_apply_torch` are the plain
  versions of the two kernels, in torch ops, drawing the same Philox numbers.
- :func:`cd_train_dp` is the run, on every rank: the kernels for CUDA
  tensors, the plain versions for CPU tensors; it never falls back.
- :func:`cd_train_dp_emulated` is a test aid: W ranks in one process, their
  buffers summed in rank order in place of the all-reduce. Nothing on the
  main path calls it.

The kernels are built with ``nvcc`` at first use, from ``ku_torch/csrc``
only, into ``ku_torch/_build`` (:mod:`ku_torch.kernels._build`).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
import torch.distributed as dist

from ku_torch.core.rng import philox_uniforms
from ku_torch.dist.mesh import axis_info, shard_batch
from ku_torch.kernels import _build
from ku_torch.kernels.cd_gibbs import (
    ROUTES,
    _check,
    _cluster_code,
    _route_code,
    launch_report,
    step_sums_torch,
)

NAME = "cd_gibbs_dp"
SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "cd_gibbs_dp.cu"
NAMES = ("rbm_weight", "hidden_bias", "visible_bias")


def build() -> tuple[Path, str]:
    """Compile the kernels if this source has not been built yet.

    Returns (library path, compiler output; empty when already built)."""
    return _build.build(SOURCE, NAME)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.cd_dp_grid.argtypes = [i, i, i, i]
    lib.cd_dp_grid.restype = i
    lib.cd_dp_scratch.argtypes = [i, i, i, i]
    lib.cd_dp_scratch.restype = ctypes.c_longlong
    lib.cd_dp_stats.argtypes = [p] * 7 + [i] * 5 + [u, i, u, i, i, i, p]
    lib.cd_dp_stats.restype = i
    lib.cd_dp_cluster.argtypes = [i, i, i, i, i, p]
    lib.cd_dp_cluster.restype = i
    lib.cd_dp_last_launch.argtypes = [p]
    lib.cd_dp_last_launch.restype = None
    lib.cd_dp_apply.argtypes = [p] * 5 + [i, i, ctypes.c_float, i, i, p]
    lib.cd_dp_apply.restype = i
    lib.cd_dp_error_string.argtypes = [i]
    lib.cd_dp_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_library().cd_dp_error_string(err).decode()} ({err})")


@functools.lru_cache(maxsize=None)
def grid_size(batch: int, v_dim: int, h_dim: int, device: int = 0) -> int:
    """Blocks of (a)'s cooperative grid on the global route at this shape
    (cached: the shape's shared-memory limit is set once)."""
    grid = _library().cd_dp_grid(batch, v_dim, h_dim, device)
    if grid < 0:
        _raise_on(-grid, "cd_dp_stats")
    return grid


@functools.lru_cache(maxsize=None)
def scratch_size(batch: int, v_dim: int, h_dim: int, device: int = 0) -> int:
    """Floats of scratch (a) needs on the global route at this shape (the
    C entry's plan)."""
    n = _library().cd_dp_scratch(batch, v_dim, h_dim, device)
    if n < 0:
        _raise_on(-n, "cd_dp_stats")
    return n


@functools.lru_cache(maxsize=None)
def cluster_size(batch: int, v_dim: int, h_dim: int, cluster: int = 0,
                 device: int = 0) -> int:
    """Blocks of (a)'s cluster on the cluster route at this shape: 16 where
    the card can co-schedule them, else 8 (``cluster`` forces one). Cached:
    the kernel's attributes are set once a shape."""
    words = (ctypes.c_int * 6)()
    _raise_on(_library().cd_dp_cluster(batch, v_dim, h_dim, cluster, device, words),
              "cd_dp_stats (cluster route)")
    return int(words[0])


def last_launch() -> dict:
    """What the last (a) launched, as its C entry reports it (see
    :func:`ku_torch.kernels.cd_gibbs.last_launch`)."""
    words = (ctypes.c_int * 6)()
    _library().cd_dp_last_launch(words)
    return launch_report(words)


def payload_size(v_dim: int, h_dim: int) -> int:
    """Floats in a step's statistics buffer: V·H + H + V + 2."""
    return v_dim * h_dim + h_dim + v_dim + 2


def _params(params):
    return tuple(params[n] for n in NAMES)


def _check_step(params, v_local, m_local, k, mode):
    w, bh, bv = _params(params)
    _check(params, v_local, m_local, k, mode, v_local.shape[0], 1)
    return w, bh, bv


def _check_cuda(tensors, what):
    _build.refuse_tracing(what, *tensors)
    device = tensors[0].device
    for t in tensors:
        if t.device != device or device.type != "cuda":
            raise ValueError(f"{what} takes CUDA tensors on one device, got "
                             f"{t.device} and {device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous float32 tensors")
    return device.index if device.index is not None else torch.cuda.current_device()


def workspace(rows: int, v_dim: int, h_dim: int, device):
    """The buffers (a) writes on the card: the statistics buffer and the
    global route's scratch for ``rows`` local rows."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    f32 = dict(dtype=torch.float32, device=device)
    return {"buf": torch.empty(payload_size(v_dim, h_dim), **f32),
            "scratch": torch.empty(scratch_size(rows, v_dim, h_dim, index), **f32)}


def stats_launcher(params, v_steps, m_steps, seed, k, mode, row0, work,
                   route=None, cluster=None):
    """(a) for a run on the card, every tensor checked once: returns
    ``launch(t, s)``, which queues (a) for flat step ``t`` on step ``s``'s
    rows, ``v_steps[s]`` (lb, V) and ``m_steps[s]`` (lb,), and returns
    ``work["buf"]``. ``params`` may change between launches in value, not
    in shape or storage. ``route`` and ``cluster`` as for
    :func:`ku_torch.kernels.cd_gibbs.cd_train_cuda`. Adds one to
    ``cd_dp_stats_cuda.launches`` and to ``cd_dp_stats_cuda.by_route[route]``
    per launch."""
    if v_steps.dim() != 3 or m_steps.shape != v_steps.shape[:2]:
        raise ValueError(f"step rows {tuple(v_steps.shape)} and masks "
                         f"{tuple(m_steps.shape)} do not match")
    w, bh, bv = _check_step(params, v_steps[0], m_steps[0], k, mode)
    dev = _check_cuda((w, bh, bv, v_steps, m_steps, *work.values()),
                      "cd_dp_stats_cuda")
    if not (0 <= int(seed) < 2**32 and 0 <= int(row0) < 2**32):
        raise ValueError(f"seed {seed} or row0 {row0} is not in [0, 2**32)")
    rows, v_dim = v_steps.shape[1:]
    h_dim = w.shape[1]
    code = _route_code(route, rows, v_dim, h_dim)
    if (work["buf"].numel() != payload_size(v_dim, h_dim)
            or (code == 0 and work["scratch"].numel() < scratch_size(rows, v_dim, h_dim, dev))):
        raise ValueError(f"the workspace does not fit {rows} rows of "
                         f"{v_dim}x{h_dim}")
    lib, buf = _library(), work["buf"]
    fixed = (w.data_ptr(), bh.data_ptr(), bv.data_ptr(), buf.data_ptr(),
             work["scratch"].data_ptr(), rows, v_dim, h_dim, int(k), int(mode),
             int(seed))
    blocks = (cluster_size(rows, v_dim, h_dim, _cluster_code(cluster), dev) if code
              else grid_size(rows, v_dim, h_dim, dev))
    tail = (int(row0), code, blocks, dev,
            torch.cuda.current_stream(v_steps.device).cuda_stream)
    v0, v_stride = v_steps.data_ptr(), 4 * rows * v_dim
    m0, m_stride = m_steps.data_ptr(), 4 * rows
    steps = v_steps.shape[0]

    def launch(t, s):
        if not 0 <= s < steps:
            raise IndexError(f"step {s} of {steps}")
        _raise_on(lib.cd_dp_stats(v0 + s * v_stride, m0 + s * m_stride, *fixed,
                                  t, *tail), f"cd_dp_stats ({ROUTES[code]} route)")
        cd_dp_stats_cuda.launches += 1
        cd_dp_stats_cuda.by_route[ROUTES[code]] += 1
        return buf

    return launch


def apply_launcher(params, lr, scores):
    """(c) for a run on the card, the parameters and scores checked once:
    returns ``launch(buf, t)``, which queues (c) for flat step ``t`` with the
    summed ``buf`` (a float32 CUDA buffer of :func:`payload_size` floats on
    the same device). Adds one to ``cd_dp_apply_cuda.launches`` per
    launch."""
    w, bh, bv = _params(params)
    dev = _check_cuda((w, bh, bv, scores), "cd_dp_apply_cuda")
    v_dim, h_dim = w.shape
    lib, n = _library(), payload_size(v_dim, h_dim)
    fixed = (w.data_ptr(), bh.data_ptr(), bv.data_ptr())
    stream = torch.cuda.current_stream(w.device).cuda_stream

    def launch(buf, t):
        if buf.numel() != n or not 0 <= t < scores.numel():
            raise ValueError(f"buffer of {buf.numel()} or step {t} does not "
                             f"fit {v_dim}x{h_dim} and {scores.numel()} scores")
        _raise_on(lib.cd_dp_apply(*fixed, buf.data_ptr(), scores.data_ptr(),
                                  v_dim, h_dim, float(lr), t, dev, stream),
                  "cd_dp_apply")
        cd_dp_apply_cuda.launches += 1

    return launch


def cd_dp_stats_cuda(params, v_local, m_local, seed, step, k, mode, row0,
                     work=None, route=None, cluster=None):
    """(a) on the card: the step's statistics over this rank's rows.

    ``v_local`` (lb, V) and ``m_local`` (lb,) are the rank's rows of the
    step and their mask, ``step`` the flat (epoch·steps + s) step, ``row0``
    the global row of ``v_local``'s first row. Returns the statistics
    buffer, ``work["buf"]`` when a :func:`workspace` is given. ``route`` and
    ``cluster`` as for :func:`stats_launcher`. Float32 contiguous CUDA
    tensors only; launches on the current stream and does not synchronise.
    Adds one to ``cd_dp_stats_cuda.launches`` per launch.
    """
    if work is None:
        work = workspace(v_local.shape[0], v_local.shape[1],
                         params["rbm_weight"].shape[1], v_local.device)
    return stats_launcher(params, v_local[None], m_local[None], seed, k, mode,
                          row0, work, route, cluster)(int(step), 0)


cd_dp_stats_cuda.launches = 0
cd_dp_stats_cuda.by_route = {r: 0 for r in ROUTES}


def cd_dp_apply_cuda(params, buf, lr, scores, step):
    """(c) on the card, in place: each parameter += lr · its part of the
    summed ``buf``, and ``scores[step]`` = Σ|ΔF| / max(Σmask, 1). Launches
    on the current stream and does not synchronise. Adds one to
    ``cd_dp_apply_cuda.launches`` per launch."""
    _check_cuda((*_params(params), buf, scores), "cd_dp_apply_cuda")
    apply_launcher(params, lr, scores)(buf, int(step))


cd_dp_apply_cuda.launches = 0


def cd_dp_stats_torch(params, v_local, m_local, seed, step, k, mode, row0,
                      uniforms=None):
    """The plain version of :func:`cd_dp_stats_cuda`, on tensors of any
    device. ``uniforms(step, n_streams, rows, cols)`` supplies the rank's
    draws (see :func:`ku_torch.kernels.cd_gibbs.cd_train_torch`); by default
    the kernel's Philox stream for ``seed`` at rows ``row0 ..``."""
    w, bh, bv = _check_step(params, v_local, m_local, k, mode)
    if uniforms is None:
        uniforms = functools.partial(philox_uniforms, int(seed),
                                     device=v_local.device, row0=int(row0))
    rows = v_local.shape[0]
    d_w, d_bh, d_bv, diff_sum, m_sum = step_sums_torch(
        w, bh, bv, v_local, m_local[:, None],
        uniforms(step, 3 * k + 1, rows, max(w.shape)), k, mode)
    return torch.cat([d_w.reshape(-1), d_bh, d_bv, diff_sum[None], m_sum[None]])


def cd_dp_apply_torch(params, buf, lr, scores, step):
    """The plain version of :func:`cd_dp_apply_cuda`, in place."""
    w, bh, bv = _params(params)
    v_dim, h_dim = w.shape
    vh = v_dim * h_dim
    w.add_(lr * buf[:vh].view(v_dim, h_dim))
    bh.add_(lr * buf[vh:vh + h_dim])
    bv.add_(lr * buf[vh + h_dim:vh + h_dim + v_dim])
    scores[step] = buf[-2] / buf[-1].clamp_min(1.0)


def _steps(v_all, batch_size, world):
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} does not divide over "
                         f"{world} ranks of the data axis")
    if batch_size < 1 or v_all.shape[0] % batch_size or v_all.shape[0] == 0:
        raise ValueError(f"{v_all.shape[0]} rows are not a positive multiple "
                         f"of batch_size {batch_size}")
    return v_all.shape[0] // batch_size, batch_size // world


def _copy(params):
    return {n: params[n].detach().clone().contiguous() for n in NAMES}


def _step_fns(device, plain):
    if plain or device.type == "cpu":
        return cd_dp_stats_torch, cd_dp_apply_torch
    if device.type == "cuda":
        return cd_dp_stats_cuda, cd_dp_apply_cuda
    raise ValueError(f"no data-parallel CD trainer for device {device}")


def cd_train_dp(mesh, params, v_all, mask, seed, lr, k, mode, batch_size,
                epochs, axis_name="data"):
    """A data-parallel CD-k run; call it on every rank of the mesh.

    Same contract as :func:`ku_torch.kernels.cd_gibbs.cd_train` plus a mesh
    (``ku.pallas.cd_gibbs.cd_train_pallas_dp``): every rank passes the whole
    padded ``v_all`` (steps·batch_size, V), its ``mask``, the same
    ``params`` and ``seed``; it moves only its own rows of each step to the
    parameters' device. Each step is (a), an all-reduce over the mesh's
    ``axis_name`` group, and (c): the kernels on CUDA tensors, the plain
    versions on CPU tensors. Returns this rank's (params, scores of shape
    (epochs·steps,)), the same on every rank. Raises ``ValueError`` if
    ``batch_size`` does not divide over the ranks. Adds one to
    ``cd_train_dp.runs``.
    """
    group, world, rank = axis_info(mesh, axis_name)
    steps, lb = _steps(v_all, batch_size, world)
    device = params["rbm_weight"].device
    v_local = shard_batch(mesh, v_all.reshape(steps, world, lb, -1), axis=1,
                          axis_name=axis_name)
    m_local = shard_batch(mesh, mask.reshape(steps, world, lb), axis=1,
                          axis_name=axis_name)
    v_local = v_local.to(device).reshape(steps, lb, -1).contiguous()
    m_local = m_local.to(device).reshape(steps, lb).contiguous()
    _check(params, v_local[0], m_local[0], k, mode, lb, epochs)
    params = _copy(params)
    scores = torch.empty(steps * epochs, dtype=params["rbm_weight"].dtype,
                         device=device)
    if v_local.device.type == "cuda":
        # Checked once; a step is then two ctypes calls and the all-reduce.
        stats = stats_launcher(params, v_local, m_local, seed, k, mode,
                               rank * lb, workspace(lb, v_local.shape[2],
                                                    params["rbm_weight"].shape[1],
                                                    device))
        apply = apply_launcher(params, lr, scores)
    elif v_local.device.type == "cpu":
        def stats(t, s):
            return cd_dp_stats_torch(params, v_local[s], m_local[s], seed, t, k,
                                     mode, rank * lb)

        def apply(buf, t):
            cd_dp_apply_torch(params, buf, lr, scores, t)
    else:
        raise ValueError(f"no data-parallel CD trainer for device {device}")

    for t in range(steps * epochs):
        buf = stats(t, t % steps)
        dist.all_reduce(buf, group=group)
        apply(buf, t)
    cd_train_dp.runs += 1
    return params, scores


cd_train_dp.runs = 0


def cd_train_dp_emulated(world, params, v_all, mask, seed, lr, k, mode,
                         batch_size, epochs, plain=False, uniforms=None,
                         route=None):
    """Test aid: a data-parallel run of ``world`` ranks in one process.

    Each step runs (a) on every rank's rows, sums the ``world`` buffers in
    rank order with torch ops in place of the all-reduce, then runs (c)
    once. The kernels on CUDA tensors unless ``plain`` (on ``route``, as
    :func:`stats_launcher` takes it); the plain versions otherwise, with
    ``uniforms`` (the same draws for every rank) if given. Nothing on the
    main path calls it.
    """
    steps, lb = _steps(v_all, batch_size, world)
    _check(params, v_all, mask, k, mode, batch_size, epochs)
    stats, apply = _step_fns(v_all.device, plain)
    extra = {"uniforms": uniforms} if uniforms is not None else {}
    if route is not None and stats is cd_dp_stats_cuda:
        extra["route"] = route
    params = _copy(params)
    scores = torch.empty(steps * epochs, dtype=params["rbm_weight"].dtype,
                         device=v_all.device)
    for t in range(steps * epochs):
        s, total = t % steps, None
        for r in range(world):
            rows = slice(s * batch_size + r * lb, s * batch_size + (r + 1) * lb)
            buf = stats(params, v_all[rows], mask[rows], seed, t, k, mode,
                        r * lb, **extra)
            total = buf.clone() if total is None else total + buf
        apply(params, total, lr, scores, t)
    return params, scores
