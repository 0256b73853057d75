"""StyleGAN's style-path layers (port of ``ku/nn/style.py``).

- :class:`StyleMixingRegularization`: with probability ``mixing_prob`` a
  cutoff drawn from [1, num_layers); layers below it take ``d1``, the rest
  ``d2``.
- :class:`TruncationTrick`: ``moving_mean`` is a registered buffer (``ku``'s
  ``batch_stats/truncation/moving_mean``). In training it is first updated
  from the layer-0 batch mean and the output is then pulled toward the
  *updated* mean with factor ``psi`` below ``cutoff``, as ``ku``'s code does
  (its docstring says the training output is untruncated; the code is
  ported). The update is kept in the graph for the output's gradient, as
  in ``ku``; the buffer stores it detached.
- :class:`MinibatchStddevConcat`: the group-wise stddev appended as
  ``num_new_features`` channels. The batch splits as ``(g, -1)``, so sample
  j shares a group with j + k·(n/g), over the channels-last layout.

Random draws come from an explicit ``torch.Generator`` (``ku``'s ``'style'``
stream); they cannot match JAX's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class StyleMixingRegularization(nn.Module):
    """Mix two broadcast dlatents ``[d1, d2]``, each (N, num_layers,
    dlatent_dim), at a random layer cutoff."""

    def __init__(self, mixing_prob: Optional[float] = None):
        super().__init__()
        self.mixing_prob = mixing_prob

    def forward(self, inputs, deterministic: bool = False,
                generator: Optional[torch.Generator] = None):
        d1, d2 = inputs
        if self.mixing_prob is None or deterministic:
            return d1
        num_layers = d1.shape[1]
        # Drawn on the device, so that the mix costs no host sync.
        mix = torch.rand((), generator=generator, device=d1.device) < self.mixing_prob
        random_cutoff = torch.randint(1, num_layers, (), generator=generator,
                                      device=d1.device)
        cutoff = torch.where(mix, random_cutoff, num_layers)
        layer_idx = torch.arange(num_layers, device=d1.device)[None, :, None]
        return torch.where(layer_idx < cutoff, d1, d2)


class TruncationTrick(nn.Module):
    """Truncation toward a moving-average dlatent, input (N, num_layers,
    dlatent_dim)."""

    def __init__(self, dlatent_dim: int, psi: float = 0.0,
                 cutoff: Optional[int] = None, momentum: float = 0.99, *,
                 device="cuda"):
        super().__init__()
        self.psi, self.cutoff, self.momentum = psi, cutoff, momentum
        self.register_buffer("moving_mean", torch.zeros(dlatent_dim, device=device))

    def forward(self, x, deterministic: bool = False):
        num_layers = x.shape[1]
        beta = torch.ones((1, num_layers, 1), dtype=x.dtype, device=x.device)
        if self.cutoff is not None:
            beta[:, :self.cutoff] = self.psi
        mean = self.moving_mean
        if not deterministic:
            mean = self.momentum * mean + (1.0 - self.momentum) * x[:, 0].mean(dim=0)
            with torch.no_grad():
                self.moving_mean.copy_(mean)
        return mean + (x - mean) * beta


class MinibatchStddevConcat(nn.Module):
    """Append the group-wise minibatch stddev (N, H, W, C) → (N, H, W,
    C + num_new_features). Computed in float32 (float64 for float64
    input)."""

    def __init__(self, group_size: int = 4, num_new_features: int = 1):
        super().__init__()
        self.group_size, self.num_new_features = group_size, num_new_features

    def forward(self, x):
        n, h, w, c = x.shape
        g = min(self.group_size, n)
        f = self.num_new_features
        y = x.reshape(g, -1, h, w, c // f, f).to(
            torch.promote_types(x.dtype, torch.float32))
        y = y - y.mean(dim=0, keepdim=True)
        y = y.square().mean(dim=0)
        y = torch.sqrt(y + 1e-8)
        y = y.mean(dim=(1, 2, 3), keepdim=True)
        y = y.mean(dim=3)
        y = y.to(x.dtype).repeat(g, h, w, 1)
        return torch.cat([x, y], dim=3)
