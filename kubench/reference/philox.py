"""Frozen copy of the port's random streams, in plain torch.

The benchmark's reference draws the same numbers as the program without
importing it, so this file copies the two streams the CD kernel and the
RBM's set-up read (``ku_torch/core/rng.py`` as of the benchmark's first
version). It must not follow later changes of the program: if the program
ever draws otherwise, the reference disagrees and the run reads false.

- :class:`SeedStream`: a CPU ``torch.Generator`` seeded with the root seed
  hands out 63-bit seeds, each one ``torch.randint(0, 2**63 - 1, ())``;
  a 32-bit kernel seed is the low word of the next one.
- :func:`uniforms`: Philox4x32-10 (Salmon et al., SC'11). Key = (seed,
  step); the uniform of (stream, row, col) is word ``col % 4`` of the
  counter (col // 4, row, stream, 0), its top 24 bits times 2**-24. Values
  live in int64 tensors below 2**32, and the 32x32-bit products are formed
  from 16-bit limbs so that nothing overflows. Many steps are drawn in one
  call: the second key word is a tensor over the steps.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32, MASK16 = 0xFFFFFFFF, 0xFFFF


class SeedStream:
    """The seeds an RBM of the program takes from its root seed, in order."""

    def __init__(self, seed: int):
        self._root = torch.Generator(device="cpu")
        self._root.manual_seed(int(seed))

    def seed64(self) -> int:
        return int(torch.randint(0, 2**63 - 1, (), generator=self._root))

    def seed32(self) -> int:
        return self.seed64() & MASK32

    def generator(self, device) -> torch.Generator:
        g = torch.Generator(device=torch.device(device))
        g.manual_seed(self.seed64())
        return g


def _mulhilo(m: int, x: torch.Tensor):
    m0, m1 = m & MASK16, m >> 16
    x0, x1 = x & MASK16, x >> 16
    p00, p01, p10, p11 = x0 * m0, x0 * m1, x1 * m0, x1 * m1
    mid = (p00 >> 16) + (p01 & MASK16) + (p10 & MASK16)
    lo = ((mid & MASK16) << 16) | (p00 & MASK16)
    hi = p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)
    return hi, lo


def _philox(c0, c1, c2, c3, k0: int, k1: torch.Tensor):
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0 = int(k0) & MASK32
    for r in range(10):
        if r:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniforms(seed: int, steps, streams, rows: int, cols: int,
             device="cpu") -> torch.Tensor:
    """Uniforms in [0, 1) of shape (len(steps), len(streams), rows, cols):
    what the kernel draws at each flat step of ``steps`` on each stream of
    ``streams``, for batch rows 0 .. rows - 1."""
    dev = torch.device(device)
    quads = -(-cols // 4)
    step = torch.as_tensor(list(steps), dtype=torch.int64, device=dev).view(-1, 1, 1, 1)
    c0 = torch.arange(quads, dtype=torch.int64, device=dev).view(1, 1, 1, quads)
    c1 = torch.arange(rows, dtype=torch.int64, device=dev).view(1, 1, rows, 1)
    c2 = torch.as_tensor(list(streams), dtype=torch.int64, device=dev).view(1, -1, 1, 1)
    c3 = torch.zeros((), dtype=torch.int64, device=dev)
    words = torch.stack(_philox(c0, c1, c2, c3, seed, step), dim=-1)
    words = words.reshape(step.shape[0], c2.shape[1], rows, 4 * quads)[..., :cols]
    return (words >> 8).to(torch.float32) * (1.0 / (1 << 24))
