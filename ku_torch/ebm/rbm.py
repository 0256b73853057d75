"""Restricted Boltzmann machine trained by contrastive divergence, in torch.

Port of ``ku/ebm/rbm.py``; the semantics are the same:

- Params: ``rbm_weight`` (V×H), ``hidden_bias`` (H), ``visible_bias`` (V),
  initialised Uniform(−0.05, 0.05).
- Bernoulli mode: h sampled as ``uniform < sigmoid(vW + b_h)``, v as
  ``uniform < sigmoid(hWᵀ + b_v)``.
- Gaussian mode: h *sampled* as ``uniform < relu(vW + b_h)`` (the
  reference's quirk, kept), v ~ Normal(hWᵀ + b_v, I). The negative-phase
  hidden *probabilities* use the sigmoid in every mode
  (:func:`neg_hidden_prob`).
- Complex mode (stacked-real v ∈ ℂ^V ↔ [Re v, Im v] ∈ ℝ^{2V}):
  P(h_j=1 | v) = sigmoid(2·(vW)_j + b_h,j), v | h ~ CN(b_v + Wh, I), i.e.
  each real component N(μ, ½), and F(v) = ‖v − b_v‖² − Σ softplus(2vW + b_h).
- CD-k: ``ΔW = lr·(v_posᵀ h_pos − v_negᵀ h_neg)`` with h_pos sampled and
  h_neg the probabilities at the chain end, raw sums over the batch; the
  per-step score is mean |F(v_pos) − F(ṽ₁)| with ṽ₁ the first sampled v.

Random numbers come from explicit ``torch.Generator`` objects, so draws
differ from ``ku``'s threefry draws (same distributions).

``RBM.fit`` runs the whole multi-epoch run as one launch of the CUDA kernel
(:mod:`ku_torch.kernels.cd_gibbs`) when its device is a GPU, and that
kernel's plain version on the CPU. ``hps["backend"] = "scan"`` asks for the
per-step loop :func:`cd_epoch_scan` instead; ``"cuda"`` (or ``"pallas"`` in
an old conf) asks for the kernel, and raises off the GPU. Under a torch
profiler, ``fit`` is the span ``ku_torch.rbm.fit`` around ``.build`` (the
parameters' first draws), ``.prep`` (the rows padded and masked) and the
kernel's ``ku_torch.cd_gibbs.launch``; ``transform`` is
``ku_torch.rbm.transform`` (:func:`ku_torch.utils.trace.trace`).

``RBM.fit(V, mesh=...)`` trains data-parallel over a
:func:`ku_torch.dist.make_mesh` mesh, called on every rank with the whole
``V``: each batch's rows split over the ranks, the statistics all-reduced
each step. It routes as ``ku`` does: with the default, ``"cuda"`` or
``"pallas"`` backend and a batch that divides over the ranks, the
data-parallel step kernels (:func:`ku_torch.kernels.cd_gibbs_dp.cd_train_dp`;
their plain versions on the CPU); otherwise the per-step loop
:func:`ku_torch.dist.cd_epoch_dp`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ku_torch.core.rng import SeedSeq
from ku_torch.utility import load_model_jh5, params_from_numpy, save_model_jh5
from ku_torch.utils.trace import trace
from ku_torch.dist.mesh import axis_info, cd_epoch_dp
from ku_torch.kernels import cd_gibbs, cd_gibbs_dp
from ku_torch.kernels.cd_gibbs import (
    MODE_COMPLEX,
    MODE_VISIBLE_BERNOULLI,
    MODE_VISIBLE_GAUSSIAN,
)

_BACKENDS = (None, "scan", "cuda", "pallas")


def _uniform_pm(shape, generator, device, dtype):
    """Uniform(−0.05, 0.05), Keras 'uniform'."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return u * 0.1 - 0.05


def init_rbm_params(generator: torch.Generator, input_dim: int,
                    output_dim: int, dtype=torch.float32):
    """Uniform(−0.05, 0.05) init on the generator's device."""
    device = generator.device
    return {
        "rbm_weight": _uniform_pm((input_dim, output_dim), generator, device, dtype),
        "hidden_bias": _uniform_pm((output_dim,), generator, device, dtype),
        "visible_bias": _uniform_pm((input_dim,), generator, device, dtype),
    }


def complex_to_stacked(v):
    """ℂ^V → ℝ^{2V}: [Re v, Im v]. Real input passes through unchanged.
    Numpy input comes back as a float32 CPU tensor."""
    if not isinstance(v, torch.Tensor):
        v = np.asarray(v)
        if np.iscomplexobj(v):
            v = np.concatenate([v.real, v.imag], axis=-1).astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(v))
    if v.is_complex():
        return torch.cat([v.real, v.imag], dim=-1)
    return v


def stacked_to_complex(v):
    """ℝ^{2V} → ℂ^V, the inverse of :func:`complex_to_stacked`."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v, np.float32))
    half = v.shape[-1] // 2
    return torch.complex(v[..., :half].float(), v[..., half:].float())


def hidden_prob(params, v, mode: int = MODE_VISIBLE_BERNOULLI):
    """P(h|v) for *sampling* h: sigmoid (Bernoulli), relu (Gaussian quirk),
    or sigmoid of the doubled activation (complex)."""
    if mode == MODE_COMPLEX:
        return torch.sigmoid(2.0 * (v @ params["rbm_weight"]) + params["hidden_bias"])
    act = v @ params["rbm_weight"] + params["hidden_bias"]
    return torch.sigmoid(act) if mode == MODE_VISIBLE_BERNOULLI else torch.relu(act)


def neg_hidden_prob(params, v, mode: int = MODE_VISIBLE_BERNOULLI):
    """Negative-phase hidden probabilities h_neg: the sigmoid in every mode
    (complex mode with its doubled activation)."""
    if mode == MODE_COMPLEX:
        return hidden_prob(params, v, mode)
    return torch.sigmoid(v @ params["rbm_weight"] + params["hidden_bias"])


def visible_stat(params, h):
    """Mean of P(v|h) before sampling: hWᵀ + b_v."""
    return h @ params["rbm_weight"].T + params["visible_bias"]


def sample_hidden(params, v, generator, mode: int = MODE_VISIBLE_BERNOULLI):
    """h ~ Bernoulli(P(h|v)), as floats."""
    p = hidden_prob(params, v, mode)
    u = torch.rand(p.shape, generator=generator, device=p.device, dtype=p.dtype)
    return (u < p).to(p.dtype)


def sample_visible(params, h, generator, mode: int = MODE_VISIBLE_BERNOULLI):
    """v: Bernoulli(sigmoid), Normal(mean, I), or, in complex mode, each
    stacked-real component N(mean, ½)."""
    stat = visible_stat(params, h)
    if mode == MODE_VISIBLE_BERNOULLI:
        p = torch.sigmoid(stat)
        u = torch.rand(p.shape, generator=generator, device=p.device, dtype=p.dtype)
        return (u < p).to(p.dtype)
    z = torch.randn(stat.shape, generator=generator, device=stat.device,
                    dtype=stat.dtype)
    return stat + (0.5 ** 0.5) * z if mode == MODE_COMPLEX else stat + z


def free_energy(params, v, mode: int = MODE_VISIBLE_BERNOULLI):
    """F(v) = −v·b_v − Σ softplus(vW + b_h); complex mode
    F(v) = ‖v − b_v‖² − Σ softplus(2vW + b_h)."""
    sp = torch.nn.functional.softplus
    if mode == MODE_COMPLEX:
        act = 2.0 * (v @ params["rbm_weight"]) + params["hidden_bias"]
        quad = ((v - params["visible_bias"]) ** 2).sum(dim=-1)
        return quad - sp(act).sum(dim=-1)
    act = v @ params["rbm_weight"] + params["hidden_bias"]
    return -(v @ params["visible_bias"] + sp(act).sum(dim=-1))


def cd_stats(params, v_pos, generator, k: int = 1,
             mode: int = MODE_VISIBLE_BERNOULLI, weight=None):
    """CD-k sufficient statistics of a batch, without the update.

    Returns ``{'d_w', 'd_bh', 'd_bv', 'score_sum', 'count'}`` as raw sums
    over rows. ``weight`` is an optional per-row 0/1 mask; masked rows
    contribute nothing."""
    h_pos = sample_hidden(params, v_pos, generator, mode)
    h = h_pos
    v_neg = v_neg_first = h_neg = None
    for i in range(k):
        v_neg = sample_visible(params, h, generator, mode)
        if v_neg_first is None:
            v_neg_first = v_neg
        h_neg = neg_hidden_prob(params, v_neg, mode)
        if i < k - 1:
            h = sample_hidden(params, v_neg, generator, mode)

    if weight is None:
        w_col = torch.ones((v_pos.shape[0], 1), dtype=v_pos.dtype, device=v_pos.device)
    else:
        w_col = weight[:, None]
    v_pos_w, v_neg_w = v_pos * w_col, v_neg * w_col
    h_pos_w, h_neg_w = h_pos * w_col, h_neg * w_col
    fe = free_energy(params, v_pos, mode)
    fe_p = free_energy(params, v_neg_first, mode)
    w_row = w_col[:, 0]
    return {
        "d_w": v_pos_w.T @ h_pos - v_neg_w.T @ h_neg,
        "d_bh": h_pos_w.sum(dim=0) - h_neg_w.sum(dim=0),
        "d_bv": v_pos_w.sum(dim=0) - v_neg_w.sum(dim=0),
        "score_sum": ((fe - fe_p).abs() * w_row).sum(),
        "count": w_row.sum(),
    }


def apply_stats(params, stats, lr):
    return {
        "rbm_weight": params["rbm_weight"] + lr * stats["d_w"],
        "hidden_bias": params["hidden_bias"] + lr * stats["d_bh"],
        "visible_bias": params["visible_bias"] + lr * stats["d_bv"],
    }


def cd_update(params, v_pos, generator, lr, k: int = 1,
              mode: int = MODE_VISIBLE_BERNOULLI, weight=None):
    """One CD-k update on a batch. Returns (params, score)."""
    stats = cd_stats(params, v_pos, generator, k, mode, weight)
    score = stats["score_sum"] / stats["count"].clamp_min(1.0)
    return apply_stats(params, stats, lr), score


def gibbs_chain(params, v0, k: int, generator, mode: int = MODE_VISIBLE_BERNOULLI):
    """k full Gibbs sweeps v → h → v from ``v0``; returns v_k."""
    v = v0
    for _ in range(k):
        h = sample_hidden(params, v, generator, mode)
        v = sample_visible(params, h, generator, mode)
    return v


def cd_epoch_scan(params, v_all, mask, generator, lr: float, k: int, mode: int,
                  batch_size: int):
    """One CD epoch as a loop of :func:`cd_update` over batches.

    ``v_all``: (steps·batch_size, V) padded data; ``mask``: the matching
    0/1 row mask. Returns (params, per-step scores)."""
    steps = v_all.shape[0] // batch_size
    scores = torch.empty(steps, dtype=v_all.dtype, device=v_all.device)
    for s in range(steps):
        rows = slice(s * batch_size, (s + 1) * batch_size)
        params, scores[s] = cd_update(params, v_all[rows], generator, lr, k,
                                      mode, weight=mask[rows])
    return params, scores


def cd_epoch_scan_pcd(params, v_all, mask, chain, generator, lr: float, k: int,
                      mode: int, batch_size: int):
    """Persistent CD epoch: the negative phase continues a persistent
    fantasy chain instead of restarting from the data (Tieleman 2008).
    Returns (params, scores, chain)."""
    steps = v_all.shape[0] // batch_size
    scores = torch.empty(steps, dtype=v_all.dtype, device=v_all.device)
    for s in range(steps):
        rows = slice(s * batch_size, (s + 1) * batch_size)
        v_b, m_b = v_all[rows], mask[rows]
        h_pos = sample_hidden(params, v_b, generator, mode)
        chain = gibbs_chain(params, chain, k, generator, mode)
        h_neg = neg_hidden_prob(params, chain, mode)
        w = m_b[:, None]
        stats = {
            "d_w": (v_b * w).T @ h_pos - (chain * w).T @ (h_neg * w),
            "d_bh": (h_pos * w).sum(dim=0) - (h_neg * w).sum(dim=0),
            "d_bv": (v_b * w).sum(dim=0) - (chain * w).sum(dim=0),
        }
        params = apply_stats(params, stats, lr)
        fe = free_energy(params, v_b, mode)
        fe_p = free_energy(params, chain, mode)
        scores[s] = ((fe - fe_p).abs() * m_b).sum() / m_b.sum().clamp_min(1.0)
    return params, scores, chain


class RBMLayer(nn.Module):
    """An RBM's forward half as a layer inside a larger model.

    Forwards P(h|v) (sigmoid, or relu in Gaussian mode), or, with
    ``sample=True`` in training mode, a Bernoulli draw from it without a
    gradient. Unless ``trainable``, the RBM weights get no gradient.
    ``device`` is ``"cuda"`` unless the caller asks for the CPU; a
    ``generator`` must live on that device."""

    def __init__(self, input_dim: int, output_dim: int,
                 mode: int = MODE_VISIBLE_BERNOULLI, sample: bool = False,
                 trainable: bool = False, generator: Optional[torch.Generator] = None,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        device = torch.device(device)
        if generator is not None and generator.device.type != device.type:
            raise ValueError(f"RBMLayer on device {device!r} got a generator on "
                             f"{generator.device}: pass one made on {device.type}, or "
                             f"device={generator.device.type!r}")
        self.mode, self.sample = mode, sample
        self.rbm_weight = nn.Parameter(_uniform_pm(
            (input_dim, output_dim), generator, device, dtype), requires_grad=trainable)
        self.hidden_bias = nn.Parameter(_uniform_pm(
            (output_dim,), generator, device, dtype), requires_grad=trainable)

    def forward(self, v, generator: Optional[torch.Generator] = None):
        act = v @ self.rbm_weight + self.hidden_bias
        p = torch.sigmoid(act) if self.mode == MODE_VISIBLE_BERNOULLI else torch.relu(act)
        if self.sample and self.training:
            u = torch.rand(p.shape, generator=generator, device=p.device, dtype=p.dtype)
            return (u < p).to(p.dtype).detach()
        return p


class RBM:
    """RBM with the reference's surface: ``fit`` / ``transform`` /
    ``inv_transform`` / ``cal_free_energy`` / ``sample`` / ``save`` / ``load``.

    ``hps``: ``lr``, ``batch_size``, ``epochs``; optional ``k`` (Gibbs
    sweeps, default 1), ``persistent`` (PCD) and ``backend`` (see the module
    docstring). ``device`` is ``"cuda"`` unless the caller asks for the CPU.
    """

    def __init__(self, hps, output_dim: int, input_dim: Optional[int] = None,
                 name: Optional[str] = None, mode: int = MODE_VISIBLE_BERNOULLI,
                 seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RBM on device 'cuda' but CUDA is not available; "
                               "pass device='cpu' to run on the CPU")
        self.hps = dict(hps)
        self.output_dim = int(output_dim)
        self.name = name
        self.mode = mode
        self._seeds = SeedSeq(seed)
        self.params = None
        self.last_scores = None
        if input_dim is not None:
            self.build(input_dim)

    # -- construction ------------------------------------------------------

    def build(self, input_dim: int):
        """``input_dim`` counts complex units in complex mode (the stored
        stacked-real parameters then have 2·input_dim visible rows)."""
        self.input_dim = int(input_dim)
        stored = 2 * self.input_dim if self.mode == MODE_COMPLEX else self.input_dim
        self.params = init_rbm_params(self._generator(), stored, self.output_dim)
        return self

    def _generator(self):
        return self._seeds.generator(self.device)

    def _ensure_built(self, v):
        if self.params is None:
            with trace("ku_torch.rbm.build"):
                self.build((v.shape if hasattr(v, "shape") else np.shape(v))[-1])

    def _to_internal(self, v, move: bool = True) -> torch.Tensor:
        """Public (maybe complex) visible array → float32 tensor on the
        device (where it is, unless ``move``), stacked-real in complex
        mode."""
        if self.mode == MODE_COMPLEX:
            v = complex_to_stacked(v)
            if self.params is not None and (
                    v.shape[-1] != self.params["visible_bias"].shape[0]):
                raise ValueError(
                    f"MODE_COMPLEX expects complex input of dim {self.input_dim} "
                    f"or stacked-real of dim {2 * self.input_dim}, got {tuple(v.shape)}")
        elif not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.asarray(v, np.float32))
        return v.to(device=self.device if move else v.device, dtype=torch.float32)

    # -- inference surface -------------------------------------------------

    def __call__(self, v, generator=None):
        return self.transform(v, generator)

    def transform(self, v, generator=None):
        """Sample hidden units given visible ones."""
        with trace("ku_torch.rbm.transform"):
            self._ensure_built(v)
            v = self._to_internal(v)
            return sample_hidden(self.params, v, generator or self._generator(), self.mode)

    def inv_transform(self, h, generator=None):
        """Sample visible units given hidden ones (complex64 in complex mode)."""
        if not isinstance(h, torch.Tensor):
            h = torch.from_numpy(np.asarray(h, np.float32))
        h = h.to(device=self.device, dtype=torch.float32)
        v = sample_visible(self.params, h, generator or self._generator(), self.mode)
        return stacked_to_complex(v) if self.mode == MODE_COMPLEX else v

    def cal_free_energy(self, v):
        """Free energy of visible configurations."""
        self._ensure_built(v)
        return free_energy(self.params, self._to_internal(v), self.mode)

    def sample(self, num_samples: int, num_steps: int = 100, v0=None,
               generator=None):
        """Samples from a Gibbs chain run for ``num_steps`` sweeps."""
        g = generator or self._generator()
        if v0 is None:
            width = self.params["visible_bias"].shape[0]
            if self.mode == MODE_COMPLEX:
                v0 = torch.randn((num_samples, width), generator=g, device=self.device)
            else:
                v0 = (torch.rand((num_samples, width), generator=g,
                                 device=self.device) < 0.5).float()
        else:
            v0 = self._to_internal(v0)
        out = gibbs_chain(self.params, v0, num_steps, g, self.mode)
        return stacked_to_complex(out) if self.mode == MODE_COMPLEX else out

    # -- training ----------------------------------------------------------

    def fit(self, V, verbose: int = 1, mesh=None):
        """Train with CD-k: on a GPU the whole run is one kernel launch.

        ``mesh``: a :func:`ku_torch.dist.make_mesh` mesh with a ``"data"``
        dimension, for data-parallel training (see the module docstring);
        every rank calls ``fit`` with the whole ``V`` and moves only its own
        rows to its device."""
        with trace("ku_torch.rbm.fit"):
            return self._fit(V, verbose, mesh)

    def _fit(self, V, verbose, mesh):
        backend = self.hps.get("backend")
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {_BACKENDS}")
        if backend in ("cuda", "pallas") and self.device.type != "cuda":
            raise ValueError(f"backend {backend!r} runs the CUDA kernel, but "
                             f"this RBM is on {self.device}")
        self._ensure_built(V)
        with trace("ku_torch.rbm.prep"):
            V = self._to_internal(V, move=mesh is None)
            batch_size = int(self.hps["batch_size"])
            epochs = int(self.hps["epochs"])
            lr = float(self.hps["lr"])
            k = int(self.hps.get("k", 1))

            n = V.shape[0]
            steps = -(-n // batch_size)
            padded = steps * batch_size
            if padded == n:
                v_all = V.contiguous()
            else:
                v_all = torch.zeros((padded, V.shape[1]), dtype=V.dtype, device=V.device)
                v_all[:n] = V
            mask = torch.zeros((padded,), dtype=torch.float32, device=V.device)
            mask[:n] = 1.0

        if mesh is not None:
            _, world, _ = axis_info(mesh)
            if backend != "scan" and batch_size % world == 0:
                self.params, scores = cd_gibbs_dp.cd_train_dp(
                    mesh, self.params, v_all, mask, self._seeds.seed32(), lr, k,
                    self.mode, batch_size, epochs)
                self._report_epochs(verbose, epochs, scores)
            else:
                for e in range(epochs):
                    self.params, scores = cd_epoch_dp(
                        mesh, self.params, v_all, mask, self._generator(), lr,
                        k, self.mode, batch_size)
                    self._report(verbose, e, epochs, scores)
        elif self.hps.get("persistent"):
            chain = v_all[:batch_size].clone()
            for e in range(epochs):
                self.params, scores, chain = cd_epoch_scan_pcd(
                    self.params, v_all, mask, chain, self._generator(), lr, k,
                    self.mode, batch_size)
                self._report(verbose, e, epochs, scores)
        elif backend == "scan":
            for e in range(epochs):
                self.params, scores = cd_epoch_scan(
                    self.params, v_all, mask, self._generator(), lr, k,
                    self.mode, batch_size)
                self._report(verbose, e, epochs, scores)
        else:
            train = cd_gibbs.cd_train if backend is None else cd_gibbs.cd_train_cuda
            self.params, scores = train(self.params, v_all, mask,
                                        self._seeds.seed32(), lr, k, self.mode,
                                        batch_size, epochs)
            self._report_epochs(verbose, epochs, scores)
        self.last_scores = scores
        return self

    @staticmethod
    def _report(verbose, e, epochs, scores):
        if verbose:
            print(f"{e + 1}/{epochs} epochs, score: {float(scores.mean()):f}")

    @staticmethod
    def _report_epochs(verbose, epochs, scores):
        """Per-epoch means of a whole run's (epochs·steps,) scores."""
        if verbose:
            for e, s in enumerate(scores.view(epochs, -1).mean(dim=1).tolist()):
                print(f"{e + 1}/{epochs} epochs, score: {s:f}")

    # -- persistence -------------------------------------------------------

    def get_config(self):
        return {
            "hps": self.hps,
            "output_dim": self.output_dim,
            "name": self.name,
            "mode": self.mode,
        }

    def save(self, name: str):
        save_model_jh5(self.get_config(), self.params, name)

    @classmethod
    def load(cls, name: str, device="cuda"):
        spec, params = load_model_jh5(name)
        rbm = cls(spec["hps"], spec["output_dim"], name=spec.get("name"),
                  mode=spec.get("mode", MODE_VISIBLE_BERNOULLI), device=device)
        rbm.params = params_from_numpy(params, device)
        stored = rbm.params["rbm_weight"].shape[0]
        rbm.input_dim = stored // 2 if rbm.mode == MODE_COMPLEX else stored
        return rbm
