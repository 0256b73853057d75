"""Position encodings, as ``ku/nn/position_encoding.py``.

- :class:`OrdinalPositionEncoding` adds the normalised ordinal position
  ``(1..N)/num_total_seq``, computed in x's dtype.
- :class:`PeriodicPositionEncoding` adds the interleaved sin/cos table with
  base ``base_n``, built in numpy as ``ku`` builds it and cast to x's dtype.

Neither has parameters, so neither adds to a state dict (as ``ku``'s add
nothing to the params tree). Both take (B, N, F) inputs.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _check_3d(x):
    if x.dim() != 3:
        raise ValueError(f"position encodings take (B, N, F) inputs, got shape "
                         f"{tuple(x.shape)}")


class OrdinalPositionEncoding(nn.Module):
    """``x + (1..N)/num_total_seq``, broadcast over the batch and features."""

    def __init__(self, num_total_seq: int):
        super().__init__()
        self.num_total_seq = num_total_seq

    def forward(self, x):
        _check_3d(x)
        pos = torch.arange(1, self.num_total_seq + 1, dtype=x.dtype,
                           device=x.device) / self.num_total_seq
        return x + pos[None, : x.shape[1], None]


class PeriodicPositionEncoding(nn.Module):
    """``x + table[:N]``, the (max_seq, d_f) table holding sin at even
    features and cos at odd ones of ``pos / base_n^(2 (f // 2) / d_f)``."""

    def __init__(self, max_seq: int, d_f: int, base_n: float = 10000.0, *,
                 device="cuda"):
        super().__init__()
        self.max_seq, self.d_f, self.base_n = max_seq, d_f, base_n
        pos = np.arange(max_seq)[:, None]
        pos_f = np.arange(d_f)[None, :]
        angle = pos / np.power(base_n, 2 * (pos_f // 2) / np.float32(d_f))
        table = np.zeros((max_seq, d_f), np.float32)
        table[:, 0::2] = np.sin(angle[:, 0::2])
        table[:, 1::2] = np.cos(angle[:, 1::2])
        self.register_buffer("table", torch.from_numpy(table).to(device),
                             persistent=False)

    def forward(self, x):
        _check_3d(x)
        return x + self.table.to(x.dtype)[None, : x.shape[1], :]
