"""Autoencoder MNIST through the encoder reversal, in torch.

Port of ``examples/autoencoder/autoencoder_mnist.py`` (a BASELINE.json
config): the decoder is not designed by hand, it is the structural reversal
of the encoder 784 → 256 → 64 → 32 (``make_autoencoder_from_encoder``),
trained through the port's ``Trainer`` on the reconstruction MSE, batch
128, Adam 1e-3, for ``max(3, ceil(1000 / steps an epoch))`` epochs.

The semi-supervised probe: ``ku`` fits sklearn's ``LogisticRegression``
(L2, C = 1, lbfgs) on the encoder's codes of the first quarter of the rows
(at least 256) and scores it on the rest. The card has no sklearn, so the
probe here is the same softmax regression, the mean cross-entropy plus
``||W||² / (2·C·n)`` (sklearn's objective over n), minimized by torch's
L-BFGS in float64 on the same split.

Run from the repository root: ``python examples_torch/autoencoder/
autoencoder_mnist.py [--device cpu]`` (the card by default). Without
MNIST's files it takes sklearn's digits, or where sklearn is absent too the
seeded MNIST-like rows (examples_torch/common.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples_torch import common  # noqa: E402
from ku_torch.backprop import make_autoencoder_from_encoder  # noqa: E402
from ku_torch.engine_ext import Trainer, adam, spec  # noqa: E402

ENCODER_SPECS = (
    spec("dense", "enc1", units=256, activation="relu"),
    spec("dense", "enc2", units=64, activation="relu"),
    spec("dense", "enc3", units=32),
)
BATCH_SIZE = 128


def mse(y, p):
    return ((y - p) ** 2).mean(dim=-1)


def softmax_probe(z_train, y_train, z_test, y_test, C: float = 1.0,
                  max_iter: int = 1000) -> float:
    """sklearn's multinomial ``LogisticRegression(C=C)`` fitted by L-BFGS in
    float64 on the codes' device; returns the test accuracy."""
    z_train, z_test = z_train.double(), z_test.double()
    y_train = torch.as_tensor(y_train, device=z_train.device)
    classes = int(max(int(y_train.max()), int(np.max(y_test)))) + 1
    w = torch.zeros(z_train.shape[1], classes, dtype=torch.float64, device=z_train.device,
                    requires_grad=True)
    b = torch.zeros(classes, dtype=torch.float64, device=z_train.device, requires_grad=True)
    opt = torch.optim.LBFGS([w, b], max_iter=max_iter, tolerance_grad=1e-10,
                            tolerance_change=1e-14, line_search_fn="strong_wolfe")
    n = z_train.shape[0]

    def objective():
        opt.zero_grad()
        loss = (torch.nn.functional.cross_entropy(z_train @ w + b, y_train)
                + (w * w).sum() / (2.0 * C * n))
        loss.backward()
        return loss

    opt.step(objective)
    with torch.no_grad():
        pred = (z_test @ w + b).argmax(dim=-1).cpu().numpy()
    return float((pred == np.asarray(y_test)).mean())


def main(device: str = "cuda", V=None, gt=None, seed: int = 0, verbose: int = 1) -> dict:
    """Train, reconstruct and probe; returns the run's numbers."""
    if V is None:
        V, gt = common.load_mnist()
    X = (np.asarray(V) / 255.0).astype(np.float32)
    g = torch.Generator().manual_seed(seed)
    ae = make_autoencoder_from_encoder(ENCODER_SPECS, (BATCH_SIZE, X.shape[1]), device="cpu",
                                       generator=g).to(device)
    trainer = Trainer(ae, mse, optimizer=adam(1e-3), seed=seed)
    steps_per_epoch = max(1, X.shape[0] // BATCH_SIZE)
    epochs = max(3, int(np.ceil(1000 / steps_per_epoch)))
    start = time.time()
    history = trainer.fit(X, X, batch_size=BATCH_SIZE, epochs=epochs, verbose=verbose)
    seconds = time.time() - start
    recon = trainer.predict(X[:2048])
    err = float(np.mean((recon - X[:2048]) ** 2))
    with torch.no_grad():
        z = torch.cat([ae.encode(torch.from_numpy(X[i:i + 4096]).to(device))
                       for i in range(0, len(X), 4096)])
    n_lab = max(256, len(z) // 4)
    acc = softmax_probe(z[:n_lab], gt[:n_lab], z[n_lab:], gt[n_lab:])
    print(f"Elasped time: {seconds:f}s")
    print(f"Reconstruction MSE: {err:.5f}")
    print(f"Semi-supervised probe accuracy ({n_lab} labels): {acc:.4f}")
    return {"epochs": epochs, "steps": epochs * steps_per_epoch, "history": history,
            "seconds": seconds, "mse": err, "probe_accuracy": acc, "n_labels": n_lab}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
