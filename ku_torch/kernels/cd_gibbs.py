"""CD-k training run as one CUDA kernel launch, with its plain version.

Port of ``ku/pallas/cd_gibbs.py`` (single-device part). The kernel,
``ku_torch/csrc/cd_gibbs.cu``, replaces ``ku/pallas/cd_gibbs.py::_make_kernel``:
one cooperative launch runs every (epoch, step) of a CD-k run, the
parameters carrying from step to step. Its source note says what bounds it
on an H100 and what the design does about that: in short, the f32
operations bound it in principle (2.7 ms for 3 epochs of 60,032 × 784 ×
128 at k = 1), but the chain of small steps leaves it latency-bound in
practice (about 123 µs a step), so one persistent launch holds W in L2 and
splits each step into a row-parallel chain phase and an update phase.

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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cd_gibbs_train.argtypes = [p] * 10 + [i] * 7 + [
        ctypes.c_float, ctypes.c_uint32, i, p]
    lib.cd_gibbs_train.restype = i
    lib.cd_gibbs_grid.argtypes = [i, i, i, i]
    lib.cd_gibbs_grid.restype = i
    lib.cd_gibbs_error_string.argtypes = [i]
    lib.cd_gibbs_error_string.restype = ctypes.c_char_p
    return lib


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


def cd_train_cuda(params, v_all, mask, seed, lr, k, mode, batch_size, epochs):
    """The whole CD-k run as one launch of the CUDA kernel.

    Takes float32 contiguous CUDA tensors, launches on the current stream and
    does not synchronise. Raises on anything else, and if the launch is
    refused. Adds one to ``cd_train_cuda.launches`` per launch.
    """
    tensors = _check(params, v_all, mask, k, mode, batch_size, epochs)
    device = v_all.device
    for t in tensors:
        if t.device != device or device.type != "cuda":
            raise ValueError("cd_train_cuda takes CUDA tensors on one device, "
                             f"got {t.device} and {device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("cd_train_cuda takes contiguous float32 tensors")
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed {seed} is not in [0, 2**32)")
    w, bh, bv = (t.clone() for t in tensors[:3])
    steps = v_all.shape[0] // batch_size
    v_dim, h_dim = w.shape
    scores = torch.empty(steps * epochs, dtype=torch.float32, device=device)
    h_pos = torch.empty(batch_size, h_dim, dtype=torch.float32, device=device)
    v_neg = torch.empty(batch_size, v_dim, dtype=torch.float32, device=device)
    h_neg = torch.empty(batch_size, h_dim, dtype=torch.float32, device=device)
    diff = torch.empty(batch_size, dtype=torch.float32, device=device)
    lib = _library()
    err = lib.cd_gibbs_train(
        v_all.data_ptr(), mask.data_ptr(), w.data_ptr(), bh.data_ptr(),
        bv.data_ptr(), scores.data_ptr(), h_pos.data_ptr(), v_neg.data_ptr(),
        h_neg.data_ptr(), diff.data_ptr(), steps, int(epochs), int(batch_size),
        v_dim, h_dim, int(k), int(mode), float(lr), int(seed),
        device.index if device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError("cd_gibbs launch failed: "
                           f"{lib.cd_gibbs_error_string(err).decode()} ({err})")
    cd_train_cuda.launches += 1
    return {"rbm_weight": w, "hidden_bias": bh, "visible_bias": bv}, scores


cd_train_cuda.launches = 0


def grid_size(batch_size, v_dim, h_dim, device=0) -> int:
    """Blocks of the kernel's cooperative grid at this shape."""
    grid = _library().cd_gibbs_grid(batch_size, v_dim, h_dim, device)
    if grid < 0:
        raise RuntimeError(_library().cd_gibbs_error_string(-grid).decode())
    return grid


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


def cd_train(params, v_all, mask, seed, lr, k, mode, batch_size, epochs):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if v_all.device.type == "cuda":
        return cd_train_cuda(params, v_all, mask, seed, lr, k, mode,
                             batch_size, epochs)
    if v_all.device.type == "cpu":
        return cd_train_torch(params, v_all, mask, seed, lr, k, mode,
                              batch_size, epochs)
    raise ValueError(f"no CD trainer for device {v_all.device}")
