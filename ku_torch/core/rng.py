"""Seed streams and the counter-based Philox4x32-10 generator.

``ku`` threads ``jax.random`` keys (``ku/core/rng.py``). Here a
:class:`SeedSeq` hands out fresh ``torch.Generator`` objects and 32-bit
kernel seeds from one root seed, and :func:`philox_uniforms` reproduces,
in torch ops, the draws that the CUDA CD kernel makes
(``ku_torch/csrc/cd_gibbs.cu``), so that the kernel and its plain version
see identical random numbers.

Philox4x32-10 (Salmon et al., SC'11): a 4×32-bit counter and a 2×32-bit
key, ten rounds. Torch has no unsigned 64-bit arithmetic, so values live in
``int64`` tensors holding numbers below 2³², and the 32×32→64-bit multiply
is done in 16-bit limbs so that no partial product overflows.
"""

from __future__ import annotations

import math

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


class SeedSeq:
    """An endless sequence of seeds and generators from one root seed.

    >>> seeds = SeedSeq(42)
    >>> g = seeds.generator("cpu")   # fresh torch.Generator
    >>> s = seeds.seed32()            # fresh 32-bit kernel seed
    """

    def __init__(self, seed: int):
        self._root = torch.Generator(device="cpu")
        self._root.manual_seed(int(seed))

    def seed64(self) -> int:
        """A fresh non-negative 63-bit seed."""
        return int(torch.randint(0, 2**63 - 1, (), generator=self._root))

    def seed32(self) -> int:
        """A fresh seed in [0, 2³²), the Philox key word of the CD kernel."""
        return self.seed64() & _MASK32

    def generator(self, device="cpu") -> torch.Generator:
        """A fresh ``torch.Generator`` on ``device``."""
        g = torch.Generator(device=torch.device(device))
        g.manual_seed(self.seed64())
        return g


class KeySeq(SeedSeq):
    """``ku``'s ``KeySeq`` surface over :class:`SeedSeq`: each call hands
    out fresh ``torch.Generator`` objects where ``ku``'s hands out keys.

    >>> ks = KeySeq(42)
    >>> g0 = ks()          # a fresh generator
    >>> g1, g2 = ks(2)     # two fresh generators
    """

    def __init__(self, seed: int, device="cpu"):
        super().__init__(seed)
        self.device = device

    def __call__(self, num: int = 1):
        gens = [self.generator(self.device) for _ in range(num)]
        return gens[0] if num == 1 else gens

    @property
    def key(self) -> int:
        """The root generator's current state as a seed (``ku``'s current
        key)."""
        return int(torch.randint(0, 2**63 - 1, (), generator=self._root.clone_state()))


def fold_step(seed: int, step: int) -> int:
    """A per-step seed derived from ``seed`` and the step counter (``ku``
    folds the step into a key)."""
    g = torch.Generator().manual_seed((int(seed) * 0x9E3779B97F4A7C15 + int(step)) % 2**63)
    return int(torch.randint(0, 2**63 - 1, (), generator=g))


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Map 32-bit random words to floats in [0, 1): the top 24 bits times
    2⁻²⁴, exact in float32 (``ku/core/rng.py`` ``uniform_from_bits``)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of ``m · x`` for a constant ``m < 2³²`` and an
    int64 tensor ``x`` of values below 2³², via 16-bit limbs."""
    m0, m1 = m & _MASK16, m >> 16
    x0, x1 = x & _MASK16, x >> 16
    p00, p01, p10, p11 = x0 * m0, x0 * m1, x1 * m0, x1 * m1
    mid = (p00 >> 16) + (p01 & _MASK16) + (p10 & _MASK16)
    lo = ((mid & _MASK16) << 16) | (p00 & _MASK16)
    hi = p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on broadcastable int64 counter tensors (values below
    2³²) and a key (k0, k1) of Python ints. Returns the four output words."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0, k1 = int(k0) & _MASK32, int(k1) & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniforms(seed: int, step: int, n_streams: int, rows: int,
                    cols: int, device="cpu", row0: int = 0) -> torch.Tensor:
    """Uniforms in [0, 1) of shape (n_streams, rows, cols), the draws the
    CD kernels make at flat step ``step`` for rows ``row0 .. row0 + rows - 1``
    of the step's global batch.

    Key = (seed, step). The uniform of (stream, row, col) is word
    ``col % 4`` of Philox on counter (col // 4, row, stream, 0). Only the
    row moves between ranks: in a data-parallel run rank r draws, for its
    rows ``r·lb ..``, exactly what a single-device run draws for the same
    rows, at any world size. (``ku`` seeds each device apart instead, with
    ``seed + step·n_dev + my_id``; the TPU's PRNG and Philox cannot give the
    same bits anyway, so the distribution is the same and the streams are
    not.)
    """
    quads = -(-cols // 4)
    dev = torch.device(device)
    c0 = torch.arange(quads, dtype=torch.int64, device=dev).view(1, 1, quads)
    c1 = torch.arange(row0, row0 + rows, dtype=torch.int64, device=dev).view(1, rows, 1)
    c2 = torch.arange(n_streams, dtype=torch.int64, device=dev).view(
        n_streams, 1, 1)
    c3 = torch.zeros((), dtype=torch.int64, device=dev)
    words = torch.stack(philox4x32(c0, c1, c2, c3, seed, step), dim=-1)
    words = words.reshape(n_streams, rows, 4 * quads)[..., :cols]
    return uniform_from_bits(words)


def box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Standard normals from two uniforms in [0, 1), the first clamped to
    1e-7 so that its log is finite: sqrt(-2 ln u1) cos(2 pi u2), as the CD
    kernel draws its Gaussian visibles."""
    u1 = u1.clamp_min(1e-7)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
