"""Deep belief network: a greedy layer-wise stack of RBMs, in torch.

Port of ``ku/ebm/dbn.py``, with its fixes of the reference: ``fit`` trains
every stacked RBM, and ``inv_transform`` walks the stack backwards. Under
a torch profiler each layer of ``fit`` is the span ``ku_torch.dbn.layer<i>``
around that RBM's ``fit`` and ``transform``.
"""

from __future__ import annotations

from typing import List, Optional

from ku_torch.ebm.rbm import RBM
from ku_torch.utils.trace import trace


class DBN:
    """Greedy layer-wise deep belief network."""

    def __init__(self, hps=None, name: Optional[str] = None):
        self.hps = hps
        self.name = name
        self.rbm_layers: List[RBM] = []

    def add_stack(self, rbm: RBM):
        """Append an RBM to the stack."""
        if not isinstance(rbm, RBM):
            raise ValueError("Only an RBM can be stacked in a DBN.")
        self.rbm_layers.append(rbm)
        return self

    @property
    def num_layers(self) -> int:
        return len(self.rbm_layers)

    def fit(self, V, verbose: int = 1, mesh=None):
        """Train RBM i, propagate ``V ← rbm_i.transform(V)``, train RBM i+1."""
        v_p = V
        for i, rbm in enumerate(self.rbm_layers):
            if verbose:
                print(f"DBN stack {i + 1}/{self.num_layers}")
            with trace(f"ku_torch.dbn.layer{i}"):
                rbm.fit(v_p, verbose=verbose, mesh=mesh)
                v_p = rbm.transform(v_p)
        return self

    def transform(self, v, generator=None):
        """Forward pass through the whole stack."""
        h = v
        for rbm in self.rbm_layers:
            h = rbm.transform(h, generator)
        return h

    def inv_transform(self, h, generator=None):
        """Backward (generative) pass through the stack, last to first."""
        v = h
        for rbm in reversed(self.rbm_layers):
            v = rbm.inv_transform(v, generator)
        return v
