"""Backend shim (port of ``ku/backend_ext``): the reference's TF-backend
names over torch ops, so that code written against ``ku``'s surface finds
the same functions.

- :func:`pad` takes TF's modes ("CONSTANT", "REFLECT", "SYMMETRIC") and
  numpy-style ``paddings``, one (before, after) pair per dim, first dim
  first. "REFLECT" and "SYMMETRIC" are index gathers along each dim
  (``F.pad`` has no symmetric mode, and its reflect takes only the last
  dims of a batched tensor); pads wider than the dim reflect again, as
  ``jnp.pad`` does.
- :func:`where` with the condition alone returns a tuple of index tensors,
  one a dim, as ``jnp.where`` does.
- :func:`cond` branches in Python on ``bool(pred)``.
- :class:`MultivariateNormalDiag` samples from a ``torch.Generator`` where
  ``ku`` takes a key; ``log_prob`` is the same formula.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.nn import functional as F

_MODES = {"CONSTANT": "constant", "REFLECT": "reflect", "SYMMETRIC": "symmetric"}


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _mirror_index(n: int, lo: int, hi: int, symmetric: bool, device):
    """Source indices of a dim of size n padded by (lo, hi): the periodic
    mirror image, with (symmetric) or without (reflect) the edge repeated."""
    i = torch.arange(-lo, n + hi, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * n if symmetric else 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j < n, j, period - j - (1 if symmetric else 0))


def pad(x, paddings, mode="CONSTANT", constant_values=0):
    x = _tensor(x)
    mode = _MODES.get(str(mode).upper(), str(mode).lower())
    pairs = [tuple(int(v) for v in p) for p in paddings]
    if len(pairs) != x.dim():
        raise ValueError(f"{len(pairs)} padding pairs for a rank-{x.dim()} tensor")
    if mode == "constant":
        arg = [v for lo_hi in reversed(pairs) for v in lo_hi]  # F.pad: last dim first
        return F.pad(x, arg, mode="constant", value=constant_values)
    if mode not in ("reflect", "symmetric"):
        raise ValueError(f"unknown padding mode {mode!r}")
    for dim, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = x.index_select(dim, _mirror_index(x.shape[dim], lo, hi,
                                                  mode == "symmetric", x.device))
    return x


def transpose(x, perm=None):
    x = _tensor(x)
    return x.permute(*(perm if perm is not None else reversed(range(x.dim()))))


def where(condition, x=None, y=None):
    condition = _tensor(condition)
    if x is None and y is None:
        return torch.nonzero(condition, as_tuple=True)
    return torch.where(condition, _tensor(x), _tensor(y))


def cond(pred, true_fn, false_fn, *operands):
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


def broadcast_to(x, shape):
    return torch.broadcast_to(_tensor(x), tuple(shape))


def add_n(xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


class MultivariateNormalDiag:
    """Minimal stand-in for ``tfp.distributions.MultivariateNormalDiag``:
    ``sample(generator, sample_shape)`` and ``log_prob``."""

    def __init__(self, loc, scale_diag=None):
        self.loc = _tensor(loc)
        if not self.loc.is_floating_point():
            self.loc = self.loc.float()
        self.scale_diag = None if scale_diag is None else _tensor(scale_diag).to(self.loc)

    def sample(self, generator: Optional[torch.Generator] = None, sample_shape=()):
        shape = tuple(sample_shape) + tuple(self.loc.shape)
        eps = torch.randn(shape, generator=generator, device=self.loc.device,
                          dtype=self.loc.dtype)
        scale = 1.0 if self.scale_diag is None else self.scale_diag
        return self.loc + eps * scale

    def log_prob(self, x):
        x = _tensor(x).to(self.loc)
        scale = torch.ones_like(self.loc) if self.scale_diag is None else self.scale_diag
        z = (x - self.loc) / scale
        return torch.sum(-0.5 * z ** 2 - torch.log(scale) - 0.5 * math.log(2.0 * math.pi),
                         dim=-1)


def multivariate_normal_diag(loc=0.0, scale_diag=None, name=None):
    return MultivariateNormalDiag(loc=loc, scale_diag=scale_diag)
