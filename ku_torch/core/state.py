"""Train-state container (port of ``ku/core/state.py``).

``ku``'s ``TrainState`` is a pytree of params, an optax state, a PRNG key
and a step, and ``apply_gradients`` returns a new one. Here the modules own
the parameters, so a state holds the parameter tensors, the
``torch.optim.Optimizer`` over them, the ``torch.Generator`` its draws come
from and the integer step, and ``apply_gradients`` updates them in place.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


class TrainState:
    """params / optimizer / generator / step."""

    def __init__(self, params: Sequence[torch.Tensor],
                 optimizer: Optional[torch.optim.Optimizer],
                 generator: Optional[torch.Generator], step: int = 0):
        self.params = list(params)
        self.optimizer = optimizer
        self.generator = generator
        self.step = int(step)

    @classmethod
    def create(cls, params, tx: Callable, generator: Optional[torch.Generator]):
        """``tx`` is an optimizer factory ``params -> Optimizer``, such as
        ``ku_torch.engine_ext.adam(...)``: the counterpart of an optax
        transformation, built over ``params`` here."""
        params = list(params)
        return cls(params, tx(params), generator, 0)

    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> "TrainState":
        """One optimizer step with ``grads`` (one per parameter, in order),
        then step + 1. The gradients are dropped after the step."""
        for p, g in zip(self.params, grads, strict=True):
            p.grad = g
        self.optimizer.step()
        for p in self.params:
            p.grad = None
        self.step += 1
        return self
