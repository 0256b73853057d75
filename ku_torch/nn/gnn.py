"""Graph convolution network layer (port of ``ku/nn/gnn.py``, Kipf &
Welling 2017).

``X' = act(D̃^-1/2 (A+I) D̃^-1/2 X W)``: D̃ is diagonal, so its inverse
square root is ``rsqrt(max(deg, 1e-12))`` applied as two broadcast
multiplies, batched over the leading axes. The weight keeps ``ku``'s name
and layout, ``gcn_weight`` (d_in, d_out), drawn from flax's
``truncated_normal(0.02)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ku_torch.nn.attention import trunc_normal
from ku_torch.nn.common import Activation, resolve_activation


class GraphConvolutionNetwork(nn.Module):
    """GCN layer on ``inputs = [X, A]``: ``X`` (..., n_node, d_in), ``A``
    (..., n_node, n_node). Returns ``X'``, or ``[X', A]`` with
    ``output_adjacency``."""

    def __init__(self, n_node: int, d_in: int, d_out: int, output_adjacency: bool = False,
                 activation: Activation = None, *, device="cuda", dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_node, self.output_adjacency = n_node, output_adjacency
        self.activation = resolve_activation(activation)
        self.gcn_weight = nn.Parameter(trunc_normal((d_in, d_out), 0.02, generator, device,
                                                    dtype))

    def forward(self, inputs):
        x, a = inputs[0], inputs[1]
        a_td = a + torch.eye(self.n_node, dtype=a.dtype, device=a.device)
        d_inv_sqrt = torch.rsqrt(a_td.sum(dim=-1).clamp_min(1e-12))
        a_hat = a_td * d_inv_sqrt[..., :, None] * d_inv_sqrt[..., None, :]
        x_p = self.activation(torch.matmul(a_hat, x) @ self.gcn_weight)
        return [x_p, a] if self.output_adjacency else x_p
