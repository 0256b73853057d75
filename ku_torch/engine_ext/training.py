"""Model-engine extensions: ``ku``'s train / test loop for a torch module,
and the structural surgery on spec lists.

Port of ``ku/engine_ext/training.py``. The ``Trainer``:

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
- Batch statistics live in the module's buffers (``BatchNorm``'s ``mean``
  / ``var``): a train step's forward, ``deterministic=False``, updates
  them in place, and ``test_step`` / ``predict`` read them. So
  ``has_batch_stats=True`` needs nothing more than ``ku``'s contract says;
  the flag is kept for it.

The structural surgery (``ku``'s ``glue_layers``, ``create_prog_specs``,
``select_params`` / ``merge_params``, ``train_on_batch_{forward,backward}
_prog_model``) works on :class:`~ku_torch.engine_ext.spec.LayerSpec` lists
and on parameter trees, nested dicts of tensors keyed by layer name (a
:class:`~ku_torch.engine_ext.spec.Stack`'s :func:`param_tree`, or ``ku``'s
params through ``ku_torch.utility.params_from_numpy``): a truncated model
shares the full model's weights by name, so selection is a dict filter.
The progressive step is plain SGD, ``p − lr·g`` on the mean loss, as
``ku``'s is.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ku_torch.engine_ext.spec import LayerSpec, Stack

PROGRESSIVE_MODE_FORWARD = 0
PROGRESSIVE_MODE_BACKWARD = 1


# -- structural surgery on spec lists ---------------------------------------


def _index_of(specs: Sequence[LayerSpec], name: str) -> int:
    for i, s in enumerate(specs):
        if s.name == name:
            return i
    raise ValueError(f"layer {name!r} not found")


def glue_layers(specs: Sequence[LayerSpec], new_specs: Sequence[LayerSpec],
                first_layer_name: Optional[str] = None,
                last_layer_name: Optional[str] = None) -> Tuple[LayerSpec, ...]:
    """Splice ``new_specs`` into ``specs``: head (``first_layer_name`` None:
    they feed the model from ``last_layer_name`` on), tail
    (``last_layer_name`` None: appended after ``first_layer_name``) or
    middle (both: everything strictly between them replaced)."""
    specs = list(specs)
    if first_layer_name is None and last_layer_name is None:
        raise ValueError("first_layer_name or last_layer_name must be given")
    if first_layer_name is None:
        return tuple(new_specs) + tuple(specs[_index_of(specs, last_layer_name):])
    if last_layer_name is None:
        return tuple(specs[: _index_of(specs, first_layer_name) + 1]) + tuple(new_specs)
    return (tuple(specs[: _index_of(specs, first_layer_name) + 1]) + tuple(new_specs)
            + tuple(specs[_index_of(specs, last_layer_name):]))


def create_prog_specs(specs: Sequence[LayerSpec], mode: int, prog_depth: int,
                      fixed_layer_names: Sequence[str] = ()) -> Tuple[LayerSpec, ...]:
    """The truncated spec list for progressive training: FORWARD keeps layers
    [0, prog_depth) plus the fixed layers, BACKWARD the fixed layers plus
    [prog_depth, end), in their original order."""
    fixed = set(fixed_layer_names)
    if mode == PROGRESSIVE_MODE_FORWARD:
        return tuple(s for i, s in enumerate(specs) if i < prog_depth or s.name in fixed)
    if mode == PROGRESSIVE_MODE_BACKWARD:
        return tuple(s for i, s in enumerate(specs) if i >= prog_depth or s.name in fixed)
    raise ValueError("mode is not valid.")


def param_tree(module: torch.nn.Module):
    """A module's parameters as a nested dict keyed by the parts of their
    names (``{"enc1": {"kernel": p, "bias": p}}``); the tensors are the
    module's own."""
    return _nest(dict(module.named_parameters()))


def select_params(full_params, specs: Sequence[LayerSpec]):
    """The sub-tree of a Stack's parameters that a truncated spec list uses."""
    names = {s.name for s in specs}
    return {k: v for k, v in full_params.items() if k in names}


def merge_params(full_params, partial_params):
    """A truncated model's trained parameters written back into the full
    tree (a new dict; the inputs are left as they are)."""
    out = dict(full_params)
    out.update(partial_params)
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _nest(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def _train_on_batch_prog(full_params, x, y, loss_fn, sub_specs, lr):
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    sub = Stack(sub_specs, tuple(x.shape), device="meta")
    flat = {k: torch.as_tensor(v).detach().requires_grad_(True)
            for k, v in _flat(select_params(full_params, sub_specs)).items()}
    loss = loss_fn(y, torch.func.functional_call(sub, flat, (x,))).mean()
    grads = torch.autograd.grad(loss, list(flat.values()))
    new_sub = {k: (p - lr * g).detach() for (k, p), g in zip(flat.items(), grads)}
    return merge_params(full_params, _nest(new_sub)), float(loss.detach())


def train_on_batch_forward_prog_model(specs, full_params, x, y, loss_fn, prog_depth: int,
                                      fixed_layer_names: Sequence[str] = (),
                                      lr: float = 1e-3):
    """One SGD step on the FORWARD-truncated sub-model, weights shared with
    the full model by name. Returns (the updated full parameter tree, the
    loss); the tree's other entries are the input's own tensors."""
    return _train_on_batch_prog(full_params, x, y, loss_fn, create_prog_specs(
        specs, PROGRESSIVE_MODE_FORWARD, prog_depth, fixed_layer_names), lr)


def train_on_batch_backward_prog_model(specs, full_params, x, y, loss_fn, prog_depth: int,
                                       fixed_layer_names: Sequence[str] = (),
                                       lr: float = 1e-3):
    """The BACKWARD-truncated counterpart."""
    return _train_on_batch_prog(full_params, x, y, loss_fn, create_prog_specs(
        specs, PROGRESSIVE_MODE_BACKWARD, prog_depth, fixed_layer_names), lr)


# -- Trainer -------------------------------------------------------------------


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
        self.has_batch_stats = has_batch_stats
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
