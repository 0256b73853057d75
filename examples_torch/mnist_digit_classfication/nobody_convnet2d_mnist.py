"""MNIST digit classification with the NobodyConvNet2D backbone, in torch.

Port of ``examples/mnist_digit_classfication/nobody_convnet2d_mnist.py``
(the directory keeps ``ku``'s spelling): x / 255 → ``NobodyConvNet2D`` at
the conf (``nobody_convnet2d_mnist_conf.json`` beside this file, a copy of
``ku``'s) → flatten in NHWC order → ``Dense(10)`` → softmax, trained on
``categorical_crossentropy_with_label_gt`` through ``Trainer(
has_batch_stats=True)`` with AdamW, then ``predict`` on the training rows,
the training-set accuracy, and ``solution.csv``.

``optax.adamw(lr, b1, b2, weight_decay=wd)`` is ``torch.optim.AdamW(lr,
betas=(b1, b2), eps=1e-8, weight_decay=wd)``: both take Adam's step and
decay every parameter by lr·wd·p on the pre-step p, so they agree to
rounding.

Run from the repository root: ``python examples_torch/
mnist_digit_classfication/nobody_convnet2d_mnist.py [--device cpu]
[--epochs N]`` (the card by default). Without MNIST's files it takes
sklearn's digits, or where sklearn is absent too the seeded MNIST-like rows
(examples_torch/common.py).
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time
from typing import Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples_torch import common  # noqa: E402
from ku_torch.applications_ext import NobodyConvNet2D  # noqa: E402
from ku_torch.core.config import load_config  # noqa: E402
from ku_torch.engine_ext import Trainer  # noqa: E402
from ku_torch.loss_ext import categorical_crossentropy_with_label_gt  # noqa: E402
from ku_torch.nn.transformer import Dense  # noqa: E402

CONF_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "nobody_convnet2d_mnist_conf.json")


class ConvNetClassifier(torch.nn.Module):
    """Backbone → flatten → Dense(10) → softmax, under flax's names
    (``NobodyConvNet2D_0``, ``Dense_0``)."""

    def __init__(self, conf, input_shape: Tuple[int, ...], *, device="cuda", dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.NobodyConvNet2D_0 = NobodyConvNet2D.from_conf(conf, input_shape, **kw)
        h, w = input_shape[1:3]
        for _ in range(2):  # the stem and Block1 halve the map, SAME at stride 2
            h, w = -(-h // 2), -(-w // 2)
        self.Dense_0 = Dense(h * w * int(conf["nn_arch"]["sp_feature_dim"]), 10, **kw)

    def forward(self, x, deterministic: bool = True):
        feat = self.NobodyConvNet2D_0(x / 255.0, deterministic=deterministic)
        return torch.softmax(self.Dense_0(feat.reshape(feat.shape[0], -1)), dim=-1)


def adamw(hps):
    """``optax.adamw(lr, b1, b2, weight_decay)`` as a factory (module
    docstring)."""
    return functools.partial(torch.optim.AdamW, lr=hps["lr"],
                             betas=(hps["beta_1"], hps["beta_2"]), eps=1e-8,
                             weight_decay=hps.get("weight_decay", 0.0))


def loss_fn(y, p):
    return categorical_crossentropy_with_label_gt(y, p, num_classes=10)


def main(device: str = "cuda", V=None, gt=None, epochs: Optional[int] = None,
         out_path: str = "solution.csv", seed: int = 0, verbose: int = 1) -> dict:
    """Train and test at the conf (``epochs`` overrides its count); returns
    the run's numbers and the trainer."""
    conf = load_config(CONF_PATH)
    hps = conf["hps"]
    if V is None:
        V, gt = common.load_mnist(flatten=False)
    V = np.asarray(V, np.float32).reshape(-1, 28, 28, 1)
    model = ConvNetClassifier(conf, (int(hps["batch_size"]),) + V.shape[1:], device="cpu",
                              generator=torch.Generator().manual_seed(seed)).to(device)
    trainer = Trainer(model, loss_fn, optimizer=adamw(hps), seed=seed, has_batch_stats=True)

    epochs = int(hps["epochs"]) if epochs is None else int(epochs)
    start = time.time()
    history = []
    if "train" in conf["mode"] and epochs > 0:
        history = trainer.fit(V, gt, batch_size=int(hps["batch_size"]), epochs=epochs,
                              verbose=verbose)
    seconds = time.time() - start
    print(f"Elasped time: {seconds:f}s")

    out = {"epochs": epochs, "steps": epochs * (len(V) // int(hps["batch_size"])),
           "history": history, "seconds": seconds, "trainer": trainer}
    if "test" in conf["mode"]:
        pred = trainer.predict(V)
        out["accuracy"] = float((np.argmax(pred, -1) == np.asarray(gt)).mean())
        print(f"Training-set accuracy: {out['accuracy']:.4f}")
        common.write_solution(pred, out_path)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epochs", type=int, default=None)
    args = ap.parse_args()
    main(args.device, epochs=args.epochs)
