"""Trainer: ``ku``'s train / test loop for a torch module.

Port of ``ku/engine_ext/training.py``'s ``Trainer`` (:147-302):

- ``loss_fn(y_true, y_pred)`` returns a per-example loss; a step minimises
  its mean. Training calls the module with ``deterministic=False``; testing
  and predicting call it with ``deterministic=True`` under
  ``torch.no_grad()``.
- The module holds its parameters from construction (``ku``'s ``init``
  draws them from ``seed``; here a module's ``generator`` does, or
  ``load_state_dict`` brings ``ku``'s), so :meth:`Trainer.init` only builds
  the optimizer's state.
- :meth:`Trainer.fit` shuffles as ``ku`` does, ``np.random.default_rng(seed)
  .permutation(n)`` each epoch, drops the ragged tail, and returns the mean
  loss of each epoch; so on the same data ``ku`` and the port see the same
  batches in the same order. ``ku``'s per-epoch ``lax.scan`` (one TPU
  dispatch an epoch) is a Python loop over the steps here, with one host
  sync an epoch for its mean loss.
- ``optimizer`` is a factory ``params -> torch.optim.Optimizer``, as an
  optax transformation is independent of the params it updates; the
  default is :func:`adam` (1e-3), ``optax.adam``'s formula and defaults.
- Random draws (dropout): with ``rng_streams`` given, as ``ku`` then passes
  rngs, each step seeds the global RNG, forked for the step, with a value
  drawn from a ``torch.Generator`` seeded with ``seed``; a run is
  reproducible from ``seed``. The draws cannot match JAX's.
- ``has_batch_stats=True`` raises ``NotImplementedError``: no module of the
  port keeps batch statistics yet.

Not in this port yet (they need ``Stack`` over ``ku/nn/{dense_composite,
gnn}.py``): ``glue_layers``, ``create_prog_specs``, ``select_params``,
``merge_params``, ``train_on_batch_{forward,backward}_prog_model`` and
``ku/engine_ext/spec.py``.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch


def adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8):
    """``optax.adam(learning_rate)`` as a factory ``params ->
    torch.optim.Adam``.

    Both take m ← b1·m + (1−b1)·g, v ← b2·v + (1−b2)·g², bias corrections
    1 − b^t on a step count that starts at 1, and the update
    lr · m̂ / (√v̂ + eps) with eps outside the square root (optax's eps_root
    0). ``torch.optim.Adam`` writes the same formula as
    lr / (1 − b1^t) · m / (√v / √(1 − b2^t) + eps), which agrees with optax
    to float32 rounding (tests/test_torch_training.py holds ``fit``'s losses
    and parameters against ``ku``'s), so it is used as it is. Its moments
    are kept in the parameters' dtype, as optax keeps them."""
    return functools.partial(torch.optim.Adam, lr=learning_rate, betas=(b1, b2),
                             eps=eps)


class Trainer:
    """Train / test loop for a torch module (``ku.engine_ext.Trainer``'s
    surface: ``init``, ``train_step``, ``test_step``, ``fit``, ``predict``).

    The module is called as ``module(x, deterministic=...)``; data go to
    the device of its parameters."""

    def __init__(self, module: torch.nn.Module, loss_fn: Callable,
                 optimizer: Optional[Callable] = None,
                 metrics: Sequence[Callable] = (), seed: int = 0,
                 has_batch_stats: bool = False, rng_streams: Sequence[str] = ()):
        if has_batch_stats:
            raise NotImplementedError(
                "has_batch_stats is not ported to ku_torch yet: no module of "
                "the port keeps batch statistics")
        self.module = module
        self.loss_fn = loss_fn
        self.make_optimizer = optimizer if optimizer is not None else adam(1e-3)
        self.metrics = list(metrics)
        self.rng_streams = tuple(rng_streams)
        self._seed = seed
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def init(self, sample_x=None):
        """Build the optimizer's state over the module's parameters (step 0).
        ``sample_x`` is ``ku``'s shape probe, not needed here."""
        self.optimizer = self.make_optimizer(
            [p for p in self.module.parameters() if p.requires_grad])
        self.step = 0
        self._draw_seeds = torch.Generator().manual_seed(self._seed)
        return self

    def _rows(self, a, rows=None):
        """``a`` (or its ``rows``) as a tensor on the module's device."""
        if isinstance(a, torch.Tensor):
            if rows is not None:
                a = a[torch.as_tensor(rows, device=a.device)]
            return a.to(self.device)
        a = np.asarray(a)
        return torch.as_tensor(a if rows is None else a[rows], device=self.device)

    @contextlib.contextmanager
    def _draws(self):
        """The step's random draws from the trainer's seed (see module
        docstring); nothing changes without ``rng_streams``."""
        if not self.rng_streams:
            yield
            return
        seed = int(torch.randint(2 ** 62, (1,), generator=self._draw_seeds))
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(seed)
            yield

    def _train_step(self, x, y):
        """One optimizer step on a batch of tensors; returns (loss, y_pred),
        detached. The step's gradients stay in the parameters' ``.grad``
        until the next step."""
        if self.optimizer is None:
            self.init(x)
        self.optimizer.zero_grad(set_to_none=True)
        with self._draws():
            y_pred = self.module(x, deterministic=False)
            loss = self.loss_fn(y, y_pred).mean()
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return loss.detach(), y_pred.detach()

    def _logs(self, loss, y, y_pred):
        logs = {"loss": float(loss)}
        for m in self.metrics:
            logs[getattr(m, "name", m.__class__.__name__)] = m(y, y_pred)
        return logs

    def train_step(self, x, y):
        """One optimizer step on (x, y); returns ``{"loss": ..., metrics}``."""
        x, y = self._rows(x), self._rows(y)
        loss, y_pred = self._train_step(x, y)
        return self._logs(loss, y, y_pred)

    def test_step(self, x, y):
        """The mean loss (and metrics) on (x, y), deterministic, no grad."""
        x, y = self._rows(x), self._rows(y)
        with torch.no_grad():
            y_pred = self.module(x, deterministic=True)
            loss = self.loss_fn(y, y_pred).mean()
        return self._logs(loss, y, y_pred)

    def fit(self, X, Y, batch_size: int, epochs: int, verbose: int = 1,
            shuffle: bool = True):
        """``epochs`` passes over (X, Y) in batches of ``batch_size``, the
        rows permuted each epoch by ``np.random.default_rng(seed)`` and the
        ragged tail dropped; returns each epoch's mean loss."""
        n = X.shape[0]
        num_steps = n // batch_size
        if num_steps == 0:
            raise ValueError(f"{n} rows make no batch of {batch_size}")
        rng = np.random.default_rng(self._seed)
        if self.optimizer is None:
            self.init()
        history = []
        for e in range(epochs):
            idx = rng.permutation(n) if shuffle else np.arange(n)
            losses = []
            for i in range(num_steps):
                rows = idx[i * batch_size:(i + 1) * batch_size]
                losses.append(self._train_step(self._rows(X, rows),
                                               self._rows(Y, rows))[0])
            history.append(float(torch.stack(losses).float().mean()))
            if verbose:
                print(f"epoch {e + 1}/{epochs} loss: {history[-1]:f}")
        return history

    def predict(self, X, batch_size: int = 256) -> np.ndarray:
        """The module's outputs on X in batches, deterministic, no grad, as
        one numpy array (bfloat16 outputs come back as float32, which numpy
        holds)."""
        outs = []
        with torch.no_grad():
            for i in range(0, X.shape[0], batch_size):
                x = self._rows(X, np.arange(i, min(i + batch_size, X.shape[0])))
                y = self.module(x, deterministic=True)
                outs.append((y.float() if y.dtype == torch.bfloat16 else y).cpu())
        return torch.cat(outs).numpy()
