"""CD-k training run as one CUDA kernel launch, with its plain version.

Port of ``ku/pallas/cd_gibbs.py`` (single-device part). The kernel,
``ku_torch/csrc/cd_gibbs.cu``, replaces ``ku/pallas/cd_gibbs.py::_make_kernel``:
one launch runs every (epoch, step) of a CD-k run, the parameters carrying
from step to step. It has two routes, chosen by the shape alone
(:func:`route_for`), never by trying one and falling back:

- the **cluster route** (``ku_torch/csrc/cd_cluster.cuh``), for every shape
  whose slices fit a block's 227 KB of shared memory at 16 blocks
  (:func:`cluster_plan`): one thread-block cluster holds W, split by visible
  rows, in its shared memory for the whole run, as ku's kernel holds it in
  VMEM, and runs each step as batched f32 products over all the batch rows,
  with cluster barriers and distributed shared memory between them;
- the **global route** (``ku_torch/csrc/cd_grid.cuh``) for a larger W: one
  persistent cooperative grid of a block an SM; W cut into tiles that the
  blocks hold in shared memory for the whole run (or read from L2 once a
  product where they do not fit); each product runs once over all the
  batch rows on the tensor cores, its partial sums meeting in L2 between six
  ``grid.sync()`` a step, and each tile's owner adds the step's sums into
  its tile. Latency bounds it: the barriers and the round trips to L2, not
  the operations.

The C entry reports what it launched; :func:`last_launch` reads it. Both
source notes say what bounds the kernel on an H100 and what the design
does about that.

- :func:`cd_train_cuda` launches the kernel. It takes CUDA tensors only.
- :func:`cd_train_torch` is the plain version: the same function as a Python
  loop of torch ops, drawing the same Philox numbers as the kernel
  (:func:`ku_torch.core.rng.philox_uniforms`), so on the card the two see
  identical draws in every mode.
- :func:`cd_train` picks by the device of the data: the kernel for a CUDA
  tensor, the plain version for a CPU tensor. It never falls back from one
  to the other.

Contract, as ``ku.pallas.cd_gibbs.cd_train_pallas``: ``v_all`` is
(steps·batch_size, V) with zero rows past the data, ``mask`` the matching
0/1 row mask; the result is (params, scores of shape (epochs·steps,)), the
score of a step taken on its pre-update parameters.

The kernel is built with ``nvcc`` at first use, from ``ku_torch/csrc`` only,
into ``ku_torch/_build`` (named by the source's hash), and loaded with
``ctypes`` (:mod:`ku_torch.kernels._build`).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ku_torch.core.rng import box_muller, philox_uniforms
from ku_torch.kernels import _build
from ku_torch.utils.trace import trace

MODE_VISIBLE_BERNOULLI = 0
MODE_VISIBLE_GAUSSIAN = 1
MODE_COMPLEX = 2

_INV_SQRT2 = 0.7071067811865476  # sigma = sqrt(1/2) for CN(mu, I) components
NAME = "cd_gibbs"
SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "cd_gibbs.cu"


def build() -> tuple[Path, str]:
    """Compile the kernel if this source has not been built yet.

    Returns (library path, compiler output; empty when already built)."""
    return _build.build(SOURCE, NAME)


ROUTES = ("global", "cluster")  # the C entries' route codes 0 and 1
SMEM_BUDGET = 232_448  # bytes of shared memory a block may use (227 KB)
MAX_CLUSTER = 16


def _split(n: int, parts: int) -> list:
    """(start, count) of each of ``parts`` contiguous slices of ``n``: the
    first ``n % parts`` take one more (cd_cluster.cuh split_start/count)."""
    base, extra = divmod(n, parts)
    return [(r * base + min(r, extra), base + (r < extra)) for r in range(parts)]


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def _plan_floats(batch_tile, nr, hc, h_dim, cluster) -> int:
    """Shared-memory floats a block of the cluster route uses
    (cd_cluster.cuh lay_out: each buffer rounded up to 16 bytes)."""
    kp, hp, bt8 = _up(nr, 8), _up(h_dim, 8), _up(batch_tile, 8)
    ldw = ldx = hp + 4
    ldv, ldp = _up(max(kp, nr + 1), 8) + 4, _up(h_dim, 32) + 8
    sizes = (max(kp, nr + 1) * ldw, bt8 * ldv, bt8 * ldv,
             max(bt8 * ldx, batch_tile * ldp), (nr + 1) * ldp, nr, nr, hc,
             4 * batch_tile, 2 * cluster * batch_tile, batch_tile,
             batch_tile * hc, 4)
    return sum(_up(n, 4) for n in sizes)


def cluster_plan(batch: int, v_dim: int, h_dim: int,
                 cluster: int = MAX_CLUSTER) -> dict:
    """The cluster route's plan at ``cluster`` blocks, as the C entries
    compute it (cd_cluster.cuh make_plan): each block's visible rows and
    hidden columns (contiguous, in rank order), the largest batch tile whose
    buffers fit :data:`SMEM_BUDGET`, the tiles a step and the bytes a block.
    ``route`` is "cluster" when a tile fits, else "global"."""
    nr, hc = -(-v_dim // cluster), -(-h_dim // cluster)
    plan = {"cluster": cluster, "rows": _split(v_dim, cluster),
            "cols": _split(h_dim, cluster), "nr": nr, "hc": hc,
            "route": "global", "batch_tile": 0, "tiles": 0, "smem_bytes": 0}
    for tiles in range(1, batch + 1):
        bt = -(-batch // tiles)
        nbytes = 4 * _plan_floats(bt, nr, hc, h_dim, cluster)
        if nbytes <= SMEM_BUDGET:
            plan.update(route="cluster", batch_tile=bt, tiles=-(-batch // bt),
                        smem_bytes=nbytes)
            break
    return plan


def route_for(batch: int, v_dim: int, h_dim: int) -> str:
    """The route a run at this shape takes: "cluster" where the cluster
    route's plan fits at 16 blocks, else "global"."""
    return cluster_plan(batch, v_dim, h_dim)["route"]


def _route_code(route, batch, v_dim, h_dim) -> int:
    route = route_for(batch, v_dim, h_dim) if route is None else route
    if route not in ROUTES:
        raise ValueError(f"route {route!r} is not one of {ROUTES}")
    return ROUTES.index(route)


def _cluster_code(cluster) -> int:
    if cluster not in (None, 8, MAX_CLUSTER):
        raise ValueError(f"cluster {cluster!r} is not None, 8 or {MAX_CLUSTER}")
    return cluster or 0


def launch_report(words) -> dict:
    """A C entry's report of its last launch, as a dict."""
    route, blocks, cluster, bt, tiles, smem = (int(x) for x in words)
    return {"route": ROUTES[route] if route >= 0 else None, "blocks": blocks,
            "cluster": cluster, "batch_tile": bt, "tiles": tiles,
            "smem_bytes": smem}


@functools.lru_cache(maxsize=None)
def _library(probe: bool = False) -> ctypes.CDLL:
    flags = ("-DCD_PROBE",) if probe else ()
    lib = ctypes.CDLL(str(_build.build(SOURCE, NAME + ("_probe" if probe else ""),
                                       flags)[0]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cd_gibbs_train.argtypes = [p] * 7 + [i] * 7 + [
        ctypes.c_float, ctypes.c_uint32, i, i, i, p]
    lib.cd_gibbs_train.restype = i
    lib.cd_gibbs_grid.argtypes = [i, i, i, i]
    lib.cd_gibbs_grid.restype = i
    lib.cd_gibbs_scratch.argtypes = [i, i, i, i]
    lib.cd_gibbs_scratch.restype = ctypes.c_longlong
    lib.cd_gibbs_plan.argtypes = [i, i, i, i, p]
    lib.cd_gibbs_plan.restype = None
    lib.cd_gibbs_last_launch.argtypes = [p]
    lib.cd_gibbs_last_launch.restype = None
    lib.cd_gibbs_error_string.argtypes = [i]
    lib.cd_gibbs_error_string.restype = ctypes.c_char_p
    if probe:
        lib.cd_gibbs_probe.argtypes = [p, i]
        lib.cd_gibbs_probe.restype = i
    return lib


def last_launch() -> dict:
    """What the last :func:`cd_train_cuda` launched, as its C entry reports
    it: route ("cluster" or "global"), blocks, cluster size (0 on the
    global route), batch tile (the global route's chunk of rows), tiles
    (of the batch on the cluster route, of W on the global route) and
    shared-memory bytes a block."""
    words = (ctypes.c_int * 6)()
    _library().cd_gibbs_last_launch(words)
    return launch_report(words)


def c_plan(batch: int, v_dim: int, h_dim: int, cluster: int) -> dict:
    """The C entry's own cluster plan (a check on :func:`cluster_plan`)."""
    words = (ctypes.c_int * 6)()
    _library().cd_gibbs_plan(batch, v_dim, h_dim, cluster, words)
    keys = ("cluster", "nr", "hc", "batch_tile", "tiles", "smem_bytes")
    return dict(zip(keys, (int(x) for x in words)))


def _check(params, v_all, mask, k, mode, batch_size, epochs):
    w, bh, bv = params["rbm_weight"], params["hidden_bias"], params["visible_bias"]
    n, v_dim = v_all.shape
    h_dim = w.shape[1]
    if w.shape != (v_dim, h_dim) or bh.shape != (h_dim,) or bv.shape != (v_dim,):
        raise ValueError(f"parameter shapes {tuple(w.shape)}, {tuple(bh.shape)}, "
                         f"{tuple(bv.shape)} do not fit data of width {v_dim}")
    if batch_size < 1 or n % batch_size or n == 0:
        raise ValueError(f"{n} rows are not a positive multiple of "
                         f"batch_size {batch_size}")
    if mask.shape != (n,):
        raise ValueError(f"mask shape {tuple(mask.shape)} != ({n},)")
    if k < 1 or epochs < 1 or mode not in (MODE_VISIBLE_BERNOULLI,
                                           MODE_VISIBLE_GAUSSIAN, MODE_COMPLEX):
        raise ValueError(f"bad k={k}, epochs={epochs} or mode={mode}")
    return (w, bh, bv, v_all, mask)


def _launch(params, v_all, mask, seed, lr, k, mode, batch_size, epochs, route,
            cluster, probe=False):
    """The run on the card through the C entry of the kernel's library (its
    probe build if ``probe``): (params, scores, route code). Checks every
    tensor before building or loading anything; raises if the launch is
    refused."""
    tensors = _check(params, v_all, mask, k, mode, batch_size, epochs)
    _build.refuse_tracing("cd_train_cuda", *tensors)
    device = v_all.device
    for t in tensors:
        if t.device != device or device.type != "cuda":
            raise ValueError("cd_train_cuda takes CUDA tensors on one device, "
                             f"got {t.device} and {device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("cd_train_cuda takes contiguous float32 tensors")
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed {seed} is not in [0, 2**32)")
    steps = v_all.shape[0] // batch_size
    v_dim, h_dim = tensors[0].shape
    with trace("ku_torch.cd_gibbs.plan"):
        code = _route_code(route, int(batch_size), v_dim, h_dim)
    index = device.index if device.index is not None else torch.cuda.current_device()
    lib = _library(probe)
    with trace("ku_torch.cd_gibbs.alloc"):
        w, bh, bv = (t.clone() for t in tensors[:3])
        scores = torch.empty(steps * epochs, dtype=torch.float32, device=device)
        # The global route's scratch; the cluster route keeps its own on chip.
        scratch = (torch.empty(_scratch_floats(lib, int(batch_size), v_dim, h_dim, index),
                               dtype=torch.float32, device=device) if code == 0 else None)
    with trace("ku_torch.cd_gibbs.call"):
        err = lib.cd_gibbs_train(
            v_all.data_ptr(), mask.data_ptr(), w.data_ptr(), bh.data_ptr(),
            bv.data_ptr(), scores.data_ptr(),
            None if scratch is None else scratch.data_ptr(), steps, int(epochs),
            int(batch_size), v_dim, h_dim, int(k), int(mode), float(lr), int(seed),
            code, _cluster_code(cluster), index,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"cd_gibbs launch failed ({ROUTES[code]} route): "
                           f"{lib.cd_gibbs_error_string(err).decode()} ({err})")
    return {"rbm_weight": w, "hidden_bias": bh, "visible_bias": bv}, scores, code


def cd_train_cuda(params, v_all, mask, seed, lr, k, mode, batch_size, epochs,
                  route=None, cluster=None):
    """The whole CD-k run as one launch of the CUDA kernel.

    ``route`` None takes :func:`route_for` the shape; "cluster" or "global"
    forces one (a cluster launch at a shape whose plan does not fit
    raises). ``cluster`` None lets the C entry take 16 blocks where the
    card can co-schedule them, else 8; 8 or 16 forces it. Takes float32
    contiguous CUDA tensors, launches on the current stream and does not
    synchronise. Raises on anything else, and if the launch is refused
    (with the CUDA error; it never runs the other route instead). Adds one
    to ``cd_train_cuda.launches`` and to ``cd_train_cuda.by_route[route]``
    per launch. Under a torch profiler the call is the span
    ``ku_torch.cd_gibbs.launch``, the checks its own time, with the children
    ``.plan`` (the route), ``.alloc`` (the copies of the parameters and the
    scratch) and ``.call`` (the C entry, which launches the kernel).
    """
    with trace("ku_torch.cd_gibbs.launch"):
        params, scores, code = _launch(params, v_all, mask, seed, lr, k, mode,
                                       batch_size, epochs, route, cluster)
    cd_train_cuda.launches += 1
    cd_train_cuda.by_route[ROUTES[code]] += 1
    return params, scores


cd_train_cuda.launches = 0
cd_train_cuda.by_route = {r: 0 for r in ROUTES}


def grid_size(batch_size, v_dim, h_dim, device=0) -> int:
    """Blocks of the global route's cooperative grid at this shape (one an
    SM)."""
    grid = _library().cd_gibbs_grid(batch_size, v_dim, h_dim, device)
    if grid < 0:
        raise RuntimeError(_library().cd_gibbs_error_string(-grid).decode())
    return grid


@functools.lru_cache(maxsize=None)
def _scratch_floats(lib, batch_size, v_dim, h_dim, device) -> int:
    """Floats of scratch a global-route launch at this shape needs (the
    C entry's plan: the partial sums of nv tiles of rows, the hidden and
    visible units, the score's terms)."""
    n = lib.cd_gibbs_scratch(batch_size, v_dim, h_dim, device)
    if n < 0:
        raise RuntimeError(f"cd_gibbs launch failed (global route): "
                           f"{lib.cd_gibbs_error_string(-n).decode()} ({-n})")
    return n


# Probe marks of the cluster route (cd_cluster.cuh CD_MARK): the interval
# ending at mark i + 1 is CLUSTER_PHASES[i]; the last is the step's
# parameter update (or the statistics' write-out).
CLUSTER_PHASES = ("(1) product", "barrier 1", "(b) owner: sums, barrier, h_pos",
                  "(b) F(v_pos) terms",
                  "barrier 2", "(2) product", "(2) v_neg draw", "(2) F(v_neg) terms",
                  "(e) mask", "(e) product", "(e) b_v sums, next copy",
                  "(3) product", "barrier 3", "(g) owner: sums, barrier, h_neg",
                  "barrier 4",
                  "(i) product", "(i) b_v sums", "(i) score", "update")
# Probe marks of the global route (cd_grid.cuh GRID_MARK), a step's phases
# in order; with k > 1 the sweep's phases are the last sweep's, and "(2)"
# holds the earlier sweeps.
GLOBAL_PHASES = ("(1) v_pos W", "grid.sync 1", "(b) h_pos", "grid.sync 2",
                 "(2) h W^T", "grid.sync 3", "(c) v_neg", "grid.sync 4",
                 "(3) v_neg W", "grid.sync 5", "(d) h_neg", "grid.sync 6",
                 "(u) dW, update, score")
_MARKS = len(CLUSTER_PHASES) + 1


def phase_split(params, v_all, mask, seed, lr, k, mode, batch_size, epochs,
                route, cluster=None, skip=8):
    """Microseconds a step in each phase of a run on ``route``, from a probe
    build of the kernel (``-DCD_PROBE``: every block stamps %globaltimer
    once all its threads end a phase; not the library the path runs).

    Returns {phase: mean us a step}, the mean over the steps after the
    first ``skip`` and over the blocks (each block's own intervals, waits
    at barriers included), plus "step" (the mean time between step starts)
    and the launch report."""
    steps = v_all.shape[0] // batch_size * epochs
    v_dim, h_dim = params["rbm_weight"].shape
    code = _route_code(route, batch_size, v_dim, h_dim)
    lib = _library(probe=True)
    if code == 1:
        plan = cluster_plan(batch_size, v_dim, h_dim, cluster or MAX_CLUSTER)
        shape = (steps, plan["tiles"], plan["cluster"], _MARKS)
    else:  # the probe build's own grid
        blocks = lib.cd_gibbs_grid(batch_size, v_dim, h_dim,
                                   v_all.device.index or 0)
        if blocks < 0:
            raise RuntimeError(lib.cd_gibbs_error_string(-blocks).decode())
        shape = (steps, blocks, len(GLOBAL_PHASES) + 1)
    stamps = torch.zeros(shape, dtype=torch.int64, device=v_all.device)
    lib.cd_gibbs_probe(stamps.data_ptr(), steps)
    try:
        _launch(params, v_all, mask, seed, lr, k, mode, batch_size, epochs, route,
                cluster, probe=True)
        torch.cuda.synchronize(v_all.device)
    finally:
        lib.cd_gibbs_probe(None, 0)
    words = (ctypes.c_int * 6)()
    lib.cd_gibbs_last_launch(words)
    t = stamps[skip:].double() / 1e3  # us
    if code == 1:
        # (steps, tiles, C, marks): intervals between successive marks of a
        # tile, summed over the tiles; the update from the last tile's
        # last-but-one mark.
        d = t[..., 1:] - t[..., :-1]
        d[:, :-1, :, -1] = 0.0  # the last mark is stamped on the last tile only
        per = d.sum(dim=1).mean(dim=(0, 1))
        split = dict(zip(CLUSTER_PHASES, per.tolist()))
        starts = t[:, 0, :, 0]
    else:
        d = t[..., 1:] - t[..., :-1]
        split = dict(zip(GLOBAL_PHASES, d.mean(dim=(0, 1)).tolist()))
        starts = t[:, :, 0]
    split["step"] = float((starts[1:] - starts[:-1]).mean())
    # The rest of a step: waiting for the copied rows and loading the mask
    # (cluster route), the loop (global route).
    split["other"] = split["step"] - sum(v for k_, v in split.items() if k_ != "step")
    split["launch"] = launch_report(words)
    return split


def _softplus30(a):
    return torch.where(a > 30.0, a, torch.log1p(torch.exp(a.clamp_max(30.0))))


def step_sums_torch(w, bh, bv, v_pos, m, u, k, mode):
    """One CD-k step's sums over the rows of ``v_pos`` on the pre-update
    parameters, in torch ops: (d_w, d_bh, d_bv, sum of score terms, sum of
    the mask), each sum raw over the rows, with ``m`` the (rows, 1) row mask
    and ``u`` the step's (3k + 1, rows, max(V, H)) uniforms. The plain
    versions of both CD kernels take their steps from it."""
    v_dim, h_dim = w.shape
    complex_mode = mode == MODE_COMPLEX

    def act(v):
        a = v @ w
        return 2.0 * a + bh if complex_mode else a + bh

    def free_energy(v, a):
        sp = _softplus30(a).sum(dim=1)
        if complex_mode:
            return ((v - bv) ** 2).sum(dim=1) - sp
        return -((v * bv).sum(dim=1) + sp)

    act_pos = act(v_pos)
    p = (torch.relu(act_pos) if mode == MODE_VISIBLE_GAUSSIAN
         else torch.sigmoid(act_pos))
    h_pos = (u[0, :, :h_dim] < p).to(w.dtype) * m
    h = h_pos
    for i in range(k):
        stat = h @ w.T + bv
        if mode == MODE_VISIBLE_BERNOULLI:
            v_neg = (u[1 + 3 * i, :, :v_dim] < torch.sigmoid(stat)).to(w.dtype)
        else:
            z = box_muller(u[1 + 3 * i, :, :v_dim], u[2 + 3 * i, :, :v_dim])
            v_neg = stat + (_INV_SQRT2 * z if complex_mode else z)
        v_neg = v_neg * m
        act_neg = act(v_neg)
        if i == 0:
            fe_neg = free_energy(v_neg, act_neg)
        # Negative-phase statistics use the sigmoid in every mode; only
        # Gaussian-mode sampling keeps the relu.
        h_neg = torch.sigmoid(act_neg) * m
        if i < k - 1:
            p_h = (torch.relu(act_neg) * m if mode == MODE_VISIBLE_GAUSSIAN
                   else h_neg)
            h = (u[3 + 3 * i, :, :h_dim] < p_h).to(w.dtype)
    diff = (free_energy(v_pos, act_pos) - fe_neg).abs() * m[:, 0]
    v_pos_m = v_pos * m
    return (v_pos_m.T @ h_pos - v_neg.T @ h_neg,
            h_pos.sum(dim=0) - h_neg.sum(dim=0),
            v_pos_m.sum(dim=0) - v_neg.sum(dim=0),
            diff.sum(), m.sum())


def cd_train_torch(params, v_all, mask, seed, lr, k, mode, batch_size, epochs,
                   uniforms=None):
    """The plain version of :func:`cd_train_cuda`: the same function as a
    Python loop of torch ops, on tensors of any device.

    ``uniforms(step, n_streams, rows, cols)`` supplies the step's uniform
    draws, stream by stream (see ``ku_torch/csrc/cd_gibbs_chain.cuh``); by
    default the kernel's Philox stream for ``seed``.
    """
    w, bh, bv, v_all, mask = _check(params, v_all, mask, k, mode, batch_size,
                                    epochs)
    if uniforms is None:
        uniforms = functools.partial(philox_uniforms, int(seed),
                                     device=v_all.device)
    b = batch_size
    steps = v_all.shape[0] // b
    cols = max(w.shape)
    scores = torch.empty(steps * epochs, dtype=w.dtype, device=w.device)
    for t in range(steps * epochs):
        s = t % steps
        d_w, d_bh, d_bv, diff_sum, m_sum = step_sums_torch(
            w, bh, bv, v_all[s * b:(s + 1) * b], mask[s * b:(s + 1) * b, None],
            uniforms(t, 3 * k + 1, b, cols), k, mode)
        scores[t] = diff_sum / m_sum.clamp_min(1.0)
        w = w + lr * d_w
        bh = bh + lr * d_bh
        bv = bv + lr * d_bv
    return {"rbm_weight": w, "hidden_bias": bh, "visible_bias": bv}, scores


def cd_train_pallas_dp(mesh, params, v_all, mask, seed, lr, k, mode, batch_size, epochs,
                       axis_name: str = "data"):
    """``ku``'s name for the data-parallel run (kernel #2):
    :func:`ku_torch.kernels.cd_gibbs_dp.cd_train_dp`, with a seed where
    ``ku`` takes a key."""
    from ku_torch.kernels.cd_gibbs_dp import cd_train_dp

    return cd_train_dp(mesh, params, v_all, mask, seed, lr, k, mode, batch_size, epochs,
                       axis_name=axis_name)


def cd_train(params, v_all, mask, seed, lr, k, mode, batch_size, epochs):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if v_all.device.type == "cuda":
        return cd_train_cuda(params, v_all, mask, seed, lr, k, mode,
                             batch_size, epochs)
    if v_all.device.type == "cpu":
        return cd_train_torch(params, v_all, mask, seed, lr, k, mode,
                              batch_size, epochs)
    raise ValueError(f"no CD trainer for device {v_all.device}")
