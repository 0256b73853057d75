"""Seeds of a run: every input, weight and sampled job of a run is drawn
from its ``--seed`` through :func:`mix`. The inputs themselves are made by
the mix's generator (``kubench/generators/<kind>.py``)."""

from __future__ import annotations

MASK63 = (1 << 63) - 1


def mix(seed: int, *tags) -> int:
    """A 63-bit seed from ``seed`` and ``tags`` (splitmix64 steps)."""
    x = int(seed) & ((1 << 64) - 1)
    for tag in tags:
        for byte in str(tag).encode():
            x = (x + 0x9E3779B97F4A7C15 + byte) & ((1 << 64) - 1)
            x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
            x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
            x ^= x >> 31
    return x & MASK63


def job_seed(seed: int, job: int, layer: int = 0) -> int:
    """The root seed of job ``job``'s model (of its ``layer``-th part). The
    warm-up job is job -1."""
    return mix(seed, "job", job, layer)
