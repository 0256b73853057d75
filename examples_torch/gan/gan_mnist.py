"""Vanilla GAN on MNIST, alternating D and G updates, in torch.

Port of ``examples/gan/gan_mnist.py``: an MLP generator 64 → 256 → 512 →
784 (ReLU, tanh out) and discriminator 784 → 512 → 256 → 1 (leaky ReLU
0.2), under flax's names (``Dense_0..2``), trained by the port's GAN engine
in the non-saturating regular mode (``STYLE_GAN_REGULAR``) at ``ku``'s conf:
5 epochs × 50 steps of one D and one G update, batch 128, ``steps_per_call``
10, Adam 2e-4 with β (0.5, 0.999) on both sides. ``BatchIter`` draws the
rows and the latents with numpy as ``ku``'s does, so both packages see the
same batches. Then 16 samples: their range, their mean and the mean
inter-sample std (a crude mode-collapse check), saved to
``results/gan_mnist_samples.npy`` in [0, 1].

Run from the repository root: ``python examples_torch/gan/gan_mnist.py
[--device cpu]`` (the card by default). Without MNIST's files it takes
sklearn's digits, or where sklearn is absent too the seeded MNIST-like rows
(examples_torch/common.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples_torch import common  # noqa: E402
from ku_torch.backprop import GAN, STYLE_GAN_REGULAR  # noqa: E402
from ku_torch.nn.common import leaky_relu  # noqa: E402
from ku_torch.nn.transformer import Dense  # noqa: E402

LATENT = 64
BATCH = 128
CONF = {
    "hps": {
        "composing_mode": STYLE_GAN_REGULAR,
        "epochs": 5,
        "batch_step": 50,
        "disc_k_step": 1,
        "steps_per_call": 10,
        "disc_ext_hps": {"lr": 2e-4, "beta_1": 0.5, "beta_2": 0.999},
        "gen_disc_hps": {"lr": 2e-4, "beta_1": 0.5, "beta_2": 0.999},
    }
}


class Generator(torch.nn.Module):
    def __init__(self, *, device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.Dense_0 = Dense(LATENT, 256, **kw)
        self.Dense_1 = Dense(256, 512, **kw)
        self.Dense_2 = Dense(512, 784, **kw)

    def forward(self, z, deterministic: bool = True):
        h = torch.relu(self.Dense_0(z))
        h = torch.relu(self.Dense_1(h))
        return torch.tanh(self.Dense_2(h))


class Discriminator(torch.nn.Module):
    def __init__(self, *, device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.Dense_0 = Dense(784, 512, **kw)
        self.Dense_1 = Dense(512, 256, **kw)
        self.Dense_2 = Dense(256, 1, **kw)

    def forward(self, x, deterministic: bool = True):
        h = leaky_relu(self.Dense_0(x), 0.2)
        h = leaky_relu(self.Dense_1(h), 0.2)
        return self.Dense_2(h)


class BatchIter:
    """Endless batches ``{"x": rows, "z": N(0, 1) latents}``, rows drawn
    with replacement by ``np.random.default_rng(seed)``."""

    def __init__(self, X, batch_size, seed=0):
        self.X, self.b = X, batch_size
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self):
        idx = self.rng.integers(0, len(self.X), size=self.b)
        return {"x": self.X[idx],
                "z": self.rng.normal(size=(self.b, LATENT)).astype(np.float32)}


def make_engine(device: str = "cuda", seed: int = 0, conf=None) -> GAN:
    """The engine at the conf, its modules drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    gen = Generator(device="cpu", generator=g).to(device)
    disc = Discriminator(device="cpu", generator=g).to(device)
    return GAN(conf or CONF, gen, disc).compose_gan_with_mode().compile()


def main(device: str = "cuda", V=None, conf=None, seed: int = 0, verbose: int = 1,
         results_dir: str = "results") -> dict:
    """Train at the conf, then sample; returns the run's numbers and the
    engine."""
    if V is None:
        V, _ = common.load_mnist()
    X = (np.asarray(V, np.float32).reshape(-1, 784) / 127.5 - 1.0).astype(np.float32)
    engine = make_engine(device, seed, conf)
    start = time.time()
    history = engine.fit_generator(BatchIter(X, BATCH), verbose=verbose)
    seconds = time.time() - start
    print(f"Elasped time: {seconds:f}s")

    z = np.random.default_rng(1).normal(size=(16, LATENT)).astype(np.float32)
    samples = engine.generate(torch.from_numpy(z)).cpu().numpy()
    print(f"sample range: [{samples.min():.3f}, {samples.max():.3f}], "
          f"mean {samples.mean():.3f}")
    os.makedirs(results_dir, exist_ok=True)
    np.save(os.path.join(results_dir, "gan_mnist_samples.npy"), (samples + 1) / 2)
    std = float(samples.std(axis=0).mean())
    print(f"inter-sample std: {std:.4f}")
    return {"history": history, "seconds": seconds, "engine": engine,
            "sample_min": float(samples.min()), "sample_max": float(samples.max()),
            "inter_sample_std": std}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
