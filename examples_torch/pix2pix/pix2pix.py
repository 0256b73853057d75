"""Pix2pix conditional GAN, digit inpainting, in torch.

Port of ``examples/pix2pix/pix2pix.py``: the condition is a digit with its
centre (rows and columns 7..20 of 28) blanked, the target the whole digit.
The generator is a symmetric-skip autoencoder made by reversing two
stride-2 ``conv2d`` specs (``make_autoencoder_with_sym_sc``), then flax's
``nn.Conv(1, (1, 1))`` (lecun-normal kernel, zero bias, SAME) and tanh; the
discriminator concatenates (cond, x) on the channels, applies two SAME
stride-2 3×3 convs with leaky ReLU 0.2, flattens in NHWC order and applies
``Dense(1)``. Names are flax's (``SymSkipAutoencoder_0``, ``Conv_0``,
``Conv_1``, ``Dense_0``). The port's GAN engine trains it in
``PIX2PIX_GAN`` mode at ``ku``'s conf: L1 weight 100, 3 epochs × 30 steps,
batch 64, Adam 2e-4 with β (0.5, 0.999). Then the L1 inside the masked
region on 256 held batches' rows against the blank input's.

Run from the repository root: ``python examples_torch/pix2pix/pix2pix.py
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
from ku_torch.backprop import GAN, PIX2PIX_GAN, make_autoencoder_with_sym_sc  # noqa: E402
from ku_torch.engine_ext import spec  # noqa: E402
from ku_torch.engine_ext.spec import Conv  # noqa: E402
from ku_torch.nn.common import leaky_relu  # noqa: E402
from ku_torch.nn.transformer import Dense  # noqa: E402

SIZE = 28
BATCH = 64
ENCODER = (
    spec("conv2d", "e1", filters=16, kernel_size=3, strides=2, padding="same",
         activation="relu"),
    spec("conv2d", "e2", filters=32, kernel_size=3, strides=2, padding="same",
         activation="relu"),
)
CONF = {
    "hps": {
        "composing_mode": PIX2PIX_GAN,
        "epochs": 3,
        "batch_step": 30,
        "disc_k_step": 1,
        "pix2pix_l1_weight": 100.0,
        "disc_ext_hps": {"lr": 2e-4, "beta_1": 0.5, "beta_2": 0.999},
        "gen_disc_hps": {"lr": 2e-4, "beta_1": 0.5, "beta_2": 0.999},
    }
}


class UNetGenerator(torch.nn.Module):
    """The symmetric-skip autoencoder over the masked image, a 1×1 conv,
    tanh."""

    def __init__(self, *, device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.SymSkipAutoencoder_0 = make_autoencoder_with_sym_sc(ENCODER, (1, SIZE, SIZE, 1),
                                                                 **kw)
        with torch.no_grad():
            channels = self.SymSkipAutoencoder_0(
                torch.zeros(1, SIZE, SIZE, 1, device=device)).shape[-1]
        self.Conv_0 = Conv(2, channels, 1, (1, 1), **kw)

    def forward(self, z, deterministic: bool = True):
        out = self.SymSkipAutoencoder_0(z, deterministic=deterministic)
        return torch.tanh(self.Conv_0(out))


class PatchDisc(torch.nn.Module):
    """The conditional discriminator over (cond, image) pairs."""

    def __init__(self, *, device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.Conv_0 = Conv(2, 2, 16, (3, 3), strides=2, **kw)
        self.Conv_1 = Conv(2, 16, 32, (3, 3), strides=2, **kw)
        side = -(-(-(-SIZE // 2)) // 2)
        self.Dense_0 = Dense(side * side * 32, 1, **kw)

    def forward(self, inputs, deterministic: bool = True):
        cond, x = inputs
        h = torch.cat([cond, x], dim=-1)
        h = leaky_relu(self.Conv_0(h), 0.2)
        h = leaky_relu(self.Conv_1(h), 0.2)
        return self.Dense_0(h.reshape(h.shape[0], -1))


def mask_slice():
    m = SIZE // 4
    return np.s_[:, m:SIZE - m, m:SIZE - m, :]


class BatchIter:
    """Endless batches ``{"x": digit, "z": masked digit, "cond": masked
    digit}``, rows drawn with replacement by ``np.random.default_rng(seed)``."""

    def __init__(self, imgs, batch, seed=0):
        self.imgs, self.b = imgs, batch
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self):
        idx = self.rng.integers(0, len(self.imgs), size=self.b)
        x = self.imgs[idx]
        cond = x.copy()
        cond[mask_slice()] = 0.0
        return {"x": x, "z": cond, "cond": cond}


def make_engine(device: str = "cuda", seed: int = 0, conf=None) -> GAN:
    """The engine at the conf, its modules drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    gen = UNetGenerator(device="cpu", generator=g).to(device)
    disc = PatchDisc(device="cpu", generator=g).to(device)
    return GAN(conf or CONF, gen, disc).compose_gan_with_mode().compile()


def main(device: str = "cuda", V=None, conf=None, seed: int = 0, verbose: int = 1,
         results_dir: str = "results") -> dict:
    """Train at the conf, then score the inpainting; returns the run's
    numbers and the engine."""
    if V is None:
        V, _ = common.load_mnist(flatten=False)
    imgs = (np.asarray(V, np.float32).reshape(-1, SIZE, SIZE, 1) / 127.5 - 1.0).astype(
        np.float32)
    engine = make_engine(device, seed, conf)
    start = time.time()
    history = engine.fit_generator(BatchIter(imgs, BATCH), verbose=verbose)
    seconds = time.time() - start
    print(f"Elasped time: {seconds:f}s")

    batch = next(BatchIter(imgs, 256, seed=9))
    fake = engine.generate(torch.from_numpy(batch["z"])).cpu().numpy()
    sl = mask_slice()
    err = float(np.abs(fake[sl] - batch["x"][sl]).mean())
    base = float(np.abs(batch["cond"][sl] - batch["x"][sl]).mean())
    print(f"masked-region L1: {err:.4f} (blank-input baseline {base:.4f})")
    os.makedirs(results_dir, exist_ok=True)
    np.save(os.path.join(results_dir, "pix2pix_samples.npy"), (fake[:16] + 1) / 2)
    return {"history": history, "seconds": seconds, "engine": engine,
            "masked_l1": err, "blank_l1": base}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
