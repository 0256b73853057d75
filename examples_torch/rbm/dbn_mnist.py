"""DBN greedy layer-wise pretraining + MNIST classification, in torch.

Port of ``examples/rbm/dbn_mnist.py``: binarized MNIST → DBN (784 → 256 →
128) trained greedily by CD, one ``RBM.fit`` a layer (on a GPU one launch
of the CD kernel each) → a softmax head trained on the frozen top-layer
probabilities, for about 660 steps. It takes the surface of
``rbm_softmax_mnist.py``: ``MNISTClassifier().train(V, gt)`` then
``.test(V, out_path)``, which writes Kaggle's ``solution.csv`` (the
working directory by default).

Run from the repository root: ``python examples_torch/rbm/dbn_mnist.py
[--device cpu]`` (the card by default).
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
from torch import nn  # noqa: E402

from examples_torch import common  # noqa: E402
from examples_torch.rbm.rbm_softmax_mnist import binarize, supervised_epochs  # noqa: E402
from ku_torch.ebm import DBN, RBM  # noqa: E402
from ku_torch.engine_ext import Trainer, adam  # noqa: E402
from ku_torch.loss_ext import categorical_crossentropy_with_label_gt  # noqa: E402
from ku_torch.nn import Dense  # noqa: E402

HPS = {"lr": 1e-3, "batch_size": 128, "epochs": 8}
DIMS = (256, 128)


class DBNSoftmax(nn.Module):
    """Frozen DBN feature stack (``w_i``, ``b_i``) → Dense(10, softmax)."""

    def __init__(self, dims=DIMS, in_dim: int = 784, *, device="cuda", generator=None):
        super().__init__()
        self.dims = tuple(dims)
        d_prev = in_dim
        for i, d in enumerate(self.dims):
            self.register_parameter(f"w_{i}", nn.Parameter(
                torch.zeros((d_prev, d), device=device), requires_grad=False))
            self.register_parameter(f"b_{i}", nn.Parameter(
                torch.zeros(d, device=device), requires_grad=False))
            d_prev = d
        self.Dense_0 = Dense(d_prev, 10, device=device, generator=generator)

    def forward(self, x, deterministic: bool = True):
        h = x
        for i in range(len(self.dims)):
            h = torch.sigmoid(h @ getattr(self, f"w_{i}") + getattr(self, f"b_{i}"))
        return torch.softmax(self.Dense_0(h), dim=-1)


class MNISTClassifier:
    """``train`` (greedy DBN, then the head) and ``test``."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.dbn = DBN(HPS)
        for i, d in enumerate(DIMS):
            self.dbn.add_stack(RBM(HPS, d, seed=i, device=self.device))
        self.model = DBNSoftmax(DIMS, device=self.device,
                                generator=torch.Generator(device=self.device).manual_seed(0))
        self.trainer = Trainer(
            self.model,
            lambda y, p: categorical_crossentropy_with_label_gt(y, p, num_classes=10),
            optimizer=adam(1e-3))

    def train(self, V=None, gt=None):
        if V is None:
            V, gt = common.load_mnist()
        Vb = binarize(V)
        print("Greedy layer-wise DBN pretraining.")
        self.dbn.fit(Vb, verbose=0)

        print("Fine-tune the softmax head.")
        with torch.no_grad():
            for i, rbm in enumerate(self.dbn.rbm_layers):
                getattr(self.model, f"w_{i}").copy_(rbm.params["rbm_weight"])
                getattr(self.model, f"b_{i}").copy_(rbm.params["hidden_bias"])
        self.trainer.init()
        batch_size = HPS["batch_size"]
        epochs = max(2, supervised_epochs(1, Vb.shape[0], batch_size, 660))
        self.trainer.fit(Vb, gt, batch_size=batch_size, epochs=epochs, verbose=0)

    def test(self, V=None, out_path: str = "solution.csv"):
        if V is None:
            V, _ = common.load_mnist()
        res = self.trainer.predict(binarize(V))
        common.write_solution(res, out_path)
        return res


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    V, gt = common.load_mnist()
    mc = MNISTClassifier(device=args.device)
    start = time.time()
    mc.train(V, gt)
    print(f"Elapsed time: {time.time() - start:f}s")
    res = mc.test(V)
    print(f"Training-set accuracy: {float((np.argmax(res, -1) == gt).mean()):.4f}")


if __name__ == "__main__":
    main()
