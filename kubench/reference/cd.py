"""Plain reference of CD-k training of a Bernoulli RBM and of greedy DBN
pretraining, in float32 torch ops.

It follows ``ku``'s definitions (``ku/ebm/rbm.py``, ``ku/ebm/dbn.py``):

- parameters W (V x H), b_h (H), b_v (V), drawn Uniform(-0.05, 0.05) in
  that order from a generator seeded by the RBM's seed stream;
- rows are cut into batches of B, the last one padded with zero rows that
  a 0/1 mask leaves out of every sum;
- a CD-k step on a batch v: h+ ~ Bernoulli(sigmoid(vW + b_h)); k sweeps of
  v- ~ Bernoulli(sigmoid(h W^T + b_v)), each but the last followed by
  h ~ Bernoulli(sigmoid(v- W + b_h)); h- = sigmoid(v- W + b_h) after the
  last; the update W += lr (v^T h+ - v-^T h-), b_h += lr sum(h+ - h-),
  b_v += lr sum(v - v-), raw sums over the batch;
- the step's score, on the parameters before its update: the mean over
  the batch's rows of |F(v) - F(v1)|, v1 the first sweep's sample, with
  F(v) = -v.b_v - sum_j softplus((vW + b_h)_j);
- a DBN trains its RBMs in turn, each on the previous one's transform,
  h ~ Bernoulli(sigmoid(vW + b_h)) drawn with a fresh generator from that
  RBM's seed stream (the transform after the last RBM is drawn too).

The draws are the program's, from the frozen copy in
:mod:`kubench.reference.philox`. A draw within rounding of its threshold
may fall either way in a sound program, and the runs part from there;
:func:`first_scores` follows the first steps along each such way.
Products run in float32 with TF32 off,
unless :func:`precision` says otherwise (the control of the benchmark's
comparison computes them in TF32). This module imports nothing of the
program.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

from kubench.reference.philox import SeedStream, uniforms

_TF32 = {"on": False}


@contextlib.contextmanager
def precision(tf32: bool):
    """Products in TF32 (``tf32``) or in float32 inside the block. On the
    card through cuBLAS's own switch; on the CPU, which has no TF32, by
    rounding both operands of each product to TF32's 10-bit mantissa."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             _TF32["on"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _TF32["on"] = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         _TF32["on"]) = saved


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _TF32["on"] and a.device.type == "cpu":
        return _tf32_round(a) @ _tf32_round(b)
    return a @ b


def softplus(a: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(a, 0.0) + torch.log1p(torch.exp(-a.abs()))


def free_energy(v, act, b_v):
    return -(mm(v, b_v[:, None])[:, 0] + softplus(act).sum(dim=1))


def init_params(gen: torch.Generator, v_dim: int, h_dim: int) -> dict:
    def draw(shape):
        return torch.rand(shape, generator=gen, device=gen.device) * 0.1 - 0.05
    return {"W": draw((v_dim, h_dim)), "b_h": draw((h_dim,)), "b_v": draw((v_dim,))}


def _chunk(rows: int, cols: int, streams: int) -> int:
    """Steps whose draws are made in one call: about 2**22 uniforms."""
    return max(1, (1 << 22) // (rows * cols * streams))


def _padded(V: torch.Tensor, batch: int):
    """(rows padded with zeros to whole batches, their 0/1 mask as a
    column, steps an epoch)."""
    n, v_dim = V.shape
    steps = -(-n // batch)
    v_all = torch.zeros((steps * batch, v_dim), dtype=torch.float32, device=V.device)
    v_all[:n] = V
    mask = (torch.arange(steps * batch, device=V.device) < n).to(torch.float32)[:, None]
    return v_all, mask, steps


def _streams(k: int) -> list:
    """The streams a Bernoulli CD-k step draws from: 0 for h+, 1 + 3i for
    sweep i's v-, 3 + 3i for its h (2 + 3i is the Gaussian modes' second
    uniform, unused here). Position 1 + 2i holds sweep i's v-, 2 + 2i its h."""
    return [0] + [s for i in range(k) for s in (1 + 3 * i, 3 + 3 * i)][:2 * k - 1]


# Draws within NEAR of their threshold may fall either way in a program
# whose probabilities differ from these by rounding: float32 and 3xTF32
# dot products of up to 2,000 terms put them within about 3e-7 of each
# other, TF32 about 1e-5 to 1e-4 away. MAX_NEAR: the nearest draws of one
# kind in one step that are followed both ways; BEAM: the paths kept
# from step to step, those closest to the scores being judged.
NEAR, MAX_NEAR, BEAM = 2e-6, 4, 16


def _draws(u, p, m, near: float) -> list:
    """The Bernoulli draws ``u < p`` on the rows of the 0/1 column ``m``:
    the draw itself and, where ``near`` > 0, every variant with a subset
    of the draws within ``near`` of their threshold flipped."""
    base = (u < p).to(torch.float32) * m
    if near <= 0:
        return [base]
    gap = (u - p).abs()
    where = ((gap < near) & (m > 0)).nonzero()
    if len(where) > MAX_NEAR:
        where = where[gap[where[:, 0], where[:, 1]].argsort()[:MAX_NEAR]]
    where = where.tolist()
    out = []
    for bits in range(1 << len(where)):
        d = base.clone()
        for j, (r, c) in enumerate(where):
            if bits >> j & 1:
                d[r, c] = 1.0 - d[r, c]
        out.append(d)
    return out


def _ends(W, b_h, b_v, v, m, u, k: int, near: float = 0.0) -> list:
    """One CD-k step's draws on the batch ``v``: [(score, h+, v-, h-)], one
    entry for each way the draws within ``near`` of their threshold may
    fall (one entry where ``near`` is 0)."""
    v_dim, h_dim = W.shape
    act_pos = mm(v, W) + b_h
    f_pos = free_energy(v, act_pos, b_v)
    out = []
    for h_pos in _draws(u[0, :, :h_dim], torch.sigmoid(act_pos), m, near):
        ends = [(h_pos, None, None, None)]  # (h to sweep from, v-, h-, F(v1))
        for i in range(k):
            nxt = []
            for h, _, _, f_neg in ends:
                p_v = torch.sigmoid(mm(h, W.T) + b_v)
                for v_neg in _draws(u[1 + 2 * i, :, :v_dim], p_v, m, near):
                    act_neg = mm(v_neg, W) + b_h
                    f = free_energy(v_neg, act_neg, b_v) if i == 0 else f_neg
                    h_neg = torch.sigmoid(act_neg) * m
                    hs = (_draws(u[2 + 2 * i, :, :h_dim], h_neg, m, near) if i < k - 1
                          else [None])
                    nxt += [(h2, v_neg, h_neg, f) for h2 in hs]
            ends = nxt
        for _, v_neg, h_neg, f_neg in ends:
            diff = (f_pos - f_neg).abs() * m[:, 0]
            out.append((diff.sum() / m.sum().clamp_min(1.0), h_pos, v_neg, h_neg))
    return out


def _update(W, b_h, b_v, v, m, h_pos, v_neg, h_neg, lr: float):
    v_m = v * m
    return (W + lr * (mm(v_m.T, h_pos) - mm(v_neg.T, h_neg)),
            b_h + lr * (h_pos.sum(dim=0) - h_neg.sum(dim=0)),
            b_v + lr * (v_m.sum(dim=0) - v_neg.sum(dim=0)))


def cd_fit(params: dict, V: torch.Tensor, seed32: int, lr: float, k: int,
           batch: int, epochs: int):
    """CD-k over ``epochs`` passes of ``V`` in batches of ``batch``.
    Returns (parameters after the run, the score of every step)."""
    W, b_h, b_v = (params[n].clone() for n in ("W", "b_h", "b_v"))
    v_all, mask, steps = _padded(V, batch)
    streams, cols = _streams(k), max(W.shape)
    total = steps * epochs
    chunk = _chunk(batch, cols, len(streams))
    scores = torch.empty(total, dtype=torch.float32, device=V.device)
    for t0 in range(0, total, chunk):
        u_all = uniforms(seed32, range(t0, min(t0 + chunk, total)), streams, batch,
                         cols, V.device)
        for t in range(t0, min(t0 + chunk, total)):
            rows = slice((t % steps) * batch, (t % steps + 1) * batch)
            v, m = v_all[rows], mask[rows]
            (scores[t], h_pos, v_neg, h_neg), = _ends(W, b_h, b_v, v, m, u_all[t - t0], k)
            W, b_h, b_v = _update(W, b_h, b_v, v, m, h_pos, v_neg, h_neg, lr)
    return {"W": W, "b_h": b_h, "b_v": b_v}, scores


def first_scores(params: dict, V: torch.Tensor, seed32: int, lr: float, k: int,
                 batch: int, got: torch.Tensor, near: float = NEAR) -> torch.Tensor:
    """The scores of the first ``len(got)`` steps along the path closest to
    ``got`` (by the largest relative gap so far) among the paths the run
    may take when the draws within ``near`` of their threshold fall either
    way. A program whose probabilities differ from the reference's by
    rounding alone takes one of these paths; the others stay out of reach
    of a program that computes in a lower precision."""
    v_all, mask, per_epoch = _padded(V, batch)
    got = got.to(device=V.device, dtype=torch.float64)
    steps = got.numel()
    streams, cols = _streams(k), max(params["W"].shape)
    u_all = uniforms(seed32, range(steps), streams, batch, cols, V.device)
    paths = [(0.0, params["W"], params["b_h"], params["b_v"], [])]
    for t in range(steps):
        rows = slice((t % per_epoch) * batch, (t % per_epoch + 1) * batch)
        v, m = v_all[rows], mask[rows]
        found = []
        for worst, W, b_h, b_v, sc in paths:
            for score, h_pos, v_neg, h_neg in _ends(W, b_h, b_v, v, m, u_all[t], k, near):
                gap = float((got[t] - score).abs() / score.abs().clamp_min(1e-30))
                found.append((max(worst, gap), W, b_h, b_v, sc + [score], h_pos, v_neg, h_neg))
        found.sort(key=lambda f: f[0])
        paths = [(worst, *_update(W, b_h, b_v, v, m, h_pos, v_neg, h_neg, lr), sc)
                 for worst, W, b_h, b_v, sc, h_pos, v_neg, h_neg in found[:BEAM]]
    return torch.stack(paths[0][-1])


def transform(params: dict, V: torch.Tensor, gen: torch.Generator,
              block: int = 1 << 16) -> torch.Tensor:
    """h ~ Bernoulli(sigmoid(V W + b_h)), the draw made for all rows at
    once as the program makes it, the products in blocks of ``block``
    rows (one block at the benchmark's 60,032 rows)."""
    u = torch.rand((V.shape[0], params["W"].shape[1]), generator=gen, device=gen.device)
    for r in range(0, V.shape[0], block):
        p = torch.sigmoid(mm(V[r:r + block], params["W"]) + params["b_h"])
        u[r:r + block] = (u[r:r + block] < p).to(torch.float32)
    return u


@dataclass
class LayerFit:
    """One RBM's run: its parameters before and after, its step scores, the
    transform of its input (the next layer's input in a DBN) and its kernel
    seed."""
    start: dict
    end: dict
    scores: torch.Tensor
    out: torch.Tensor = field(default=None, repr=False)
    seed32: int = 0


def rbm_fit(seed: int, V: torch.Tensor, h_dim: int, lr: float, k: int, batch: int,
            epochs: int, with_transform: bool = False) -> LayerFit:
    """A fresh RBM of root seed ``seed`` trained on ``V`` (the program's
    ``RBM(hps, h_dim, seed=seed).fit(V)``); ``with_transform`` draws its
    transform of ``V`` afterwards, as a DBN does."""
    seeds = SeedStream(seed)
    start = init_params(seeds.generator(V.device), V.shape[1], h_dim)
    seed32 = seeds.seed32()
    end, scores = cd_fit(start, V, seed32, lr, k, batch, epochs)
    out = transform(end, V, seeds.generator(V.device)) if with_transform else None
    return LayerFit(start, end, scores, out, seed32)


def dbn_fit(seeds, V: torch.Tensor, widths, lr: float, k: int, batch: int,
            epochs: int) -> list:
    """Greedy pretraining of a stack of RBMs of hidden widths ``widths``,
    the i-th of root seed ``seeds[i]``: one :class:`LayerFit` a layer."""
    layers, v = [], V
    for seed, h_dim in zip(seeds, widths):
        layer = rbm_fit(seed, v, h_dim, lr, k, batch, epochs, with_transform=True)
        layers.append(layer)
        v = layer.out
    return layers
