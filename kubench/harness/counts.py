"""Operations and bytes of the work a job asks for, from its shapes alone.

A CD-k step on a batch of B rows of an RBM with V visible and H hidden
units makes 2k + 3 products of 2·B·V·H operations: one for h+, 2k for the
Gibbs sweeps, two for the outer products v^T h+ and v-^T h-. Padded rows
count, as the kernel computes them. A run's bytes: the data and its row
mask read once, the parameters read once and written once, one score a
step written.
"""

from __future__ import annotations


def steps(rows: int, batch: int) -> int:
    return -(-rows // batch)


def cd_flops(rows: int, v: int, h: int, batch: int, k: int, epochs: int) -> int:
    return (2 * k + 3) * 2 * batch * v * h * steps(rows, batch) * epochs


def cd_bytes(rows: int, v: int, h: int, batch: int, epochs: int, itemsize: int = 4) -> int:
    padded = steps(rows, batch) * batch
    return itemsize * (padded * v + padded + 2 * (v * h + v + h)
                       + steps(rows, batch) * epochs)


def transform_flops(rows: int, v: int, h: int) -> int:
    """A DBN layer's transform of its rows: one product."""
    return 2 * rows * v * h


def least_seconds(flops: int, nbytes: int, peak_flops: float, peak_bytes: float):
    """The least time the card could take: (seconds, "operations" or
    "bytes", whichever bounds it)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
