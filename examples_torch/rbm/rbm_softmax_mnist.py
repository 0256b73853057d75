"""Semi-supervised MNIST: RBM pretraining + softmax classifier, in torch.

Port of ``examples/rbm/rbm_softmax_mnist.py``, with its conf
(``examples/rbm/rbm_softmax_mnist_conf.json``, read in place) and its class
surface: ``MNISTClassifier(conf).train(V, gt)`` then ``.test(V,
out_path)``, which writes Kaggle's ``solution.csv``. The model is /255 →
binarized pixels → the RBM's hidden probabilities (frozen) → Dense(10,
softmax).

- The RBM trains on the binarized visibles by CD through ``RBM.fit``: on a
  GPU one launch of the CD kernel (``ku_torch.kernels.cd_gibbs``).
- The supervised phase runs the port's ``Trainer`` with the conf's Adam
  and ``categorical_crossentropy_with_label_gt``; the conf's epochs are
  scaled to about 330 steps an epoch on a dataset smaller than Kaggle's.
- The fitted model goes to ``<model_dir>/digit_classificaton_model.{json,
  npz}``; ``solution.csv`` to the path given to ``test``. Both default to
  the working directory.

Run from the repository root: ``python examples_torch/rbm/rbm_softmax_mnist.py
[--device cpu]`` (the card by default). Without MNIST's files it takes
sklearn's digits (examples_torch/common.py).
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
from ku_torch.core.config import load_config  # noqa: E402
from ku_torch.ebm import RBM  # noqa: E402
from ku_torch.engine_ext import Trainer, adam  # noqa: E402
from ku_torch.loss_ext import categorical_crossentropy_with_label_gt  # noqa: E402
from ku_torch.nn import Dense  # noqa: E402
from ku_torch.utility import save_model_jh5, tree_from_state_dict  # noqa: E402

CONF_PATH = os.path.join(common.KU_EXAMPLES, "rbm", "rbm_softmax_mnist_conf.json")


def binarize(V) -> np.ndarray:
    """The RBM's visible distribution: pixels / 255 > 0.5."""
    return (np.asarray(V, np.float32) / 255.0 > 0.5).astype(np.float32)


def supervised_epochs(epochs: int, n: int, batch_size: int, steps: int) -> int:
    """``epochs`` scaled so that an epoch of the conf takes about ``steps``
    optimizer steps on ``n`` rows."""
    steps_per_epoch = max(1, n // batch_size)
    return epochs * max(1, int(np.ceil(steps / steps_per_epoch)))


class RBMSoftmaxModel(nn.Module):
    """/255 → binarized → RBM hidden probabilities (frozen) → Dense(10,
    softmax). ``rbm_weight`` and ``rbm_hidden_bias`` take no gradient."""

    def __init__(self, input_dim: int = 784, output_dim: int = 128, *,
                 device="cuda", generator=None):
        super().__init__()
        self.rbm_weight = nn.Parameter(torch.zeros((input_dim, output_dim), device=device),
                                       requires_grad=False)
        self.rbm_hidden_bias = nn.Parameter(torch.zeros(output_dim, device=device),
                                            requires_grad=False)
        self.softmax = Dense(output_dim, 10, device=device, generator=generator)

    def forward(self, x, deterministic: bool = True):
        x = (x / 255.0 > 0.5).float()
        h = torch.sigmoid(x @ self.rbm_weight + self.rbm_hidden_bias)
        return torch.softmax(self.softmax(h), dim=-1)


class MNISTClassifier:
    """The reference's class surface: ``train`` and ``test``."""

    MODEL_PATH = "digit_classificaton_model"

    def __init__(self, conf, device="cuda", model_dir: str = "."):
        self.conf = conf
        self.hps = conf["hps"]
        self.nn_arch = conf["nn_arch"]
        self.model_path = os.path.join(model_dir, self.MODEL_PATH)
        self.device = torch.device(device)
        self.rbm = RBM(conf["rbm_hps"], self.nn_arch["output_dim"], seed=0,
                       device=self.device)
        self.model = RBMSoftmaxModel(
            output_dim=self.nn_arch["output_dim"], device=self.device,
            generator=torch.Generator(device=self.device).manual_seed(0))
        self.trainer = Trainer(
            self.model,
            lambda y, p: categorical_crossentropy_with_label_gt(y, p, num_classes=10),
            optimizer=adam(self.hps["lr"], b1=self.hps["beta_1"], b2=self.hps["beta_2"]),
        )
        if conf["model_loading"]:
            from ku_torch.utility import load_model_jh5, state_dict_from_tree

            _, params = load_model_jh5(self.model_path)
            self.model.load_state_dict(state_dict_from_tree(params, self.device),
                                       strict=True)

    def train(self, V=None, gt=None):
        if V is None:
            V, gt = common.load_mnist()
        print("Train the RBM model.")
        self.rbm.fit(binarize(V), verbose=0)

        print("Train the NN model.")
        with torch.no_grad():
            self.model.rbm_weight.copy_(self.rbm.params["rbm_weight"])
            self.model.rbm_hidden_bias.copy_(self.rbm.params["hidden_bias"])
        self.trainer.init()
        batch_size = int(self.hps["batch_size"])
        epochs = supervised_epochs(int(self.hps["epochs"]), V.shape[0], batch_size, 330)
        self.trainer.fit(V, gt, batch_size=batch_size, epochs=epochs, verbose=0)
        loss = self.trainer.test_step(V[:512], gt[:512])["loss"]
        print(f"supervised: {epochs} epoch(s), final loss {loss:f}")

        print("Save the model.")
        save_model_jh5(dict(self.conf), tree_from_state_dict(self.model.state_dict()),
                       self.model_path)

    def test(self, V=None, out_path: str = "solution.csv"):
        if V is None:
            V, _ = common.load_mnist()
        res = self.trainer.predict(V)
        common.write_solution(res, out_path)
        return res


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    conf = load_config(CONF_PATH)
    mc = MNISTClassifier(conf, device=args.device)
    start = time.time()
    if "train" in conf["mode"]:
        mc.train()
    print(f"Elapsed time: {time.time() - start:f}s")
    if "test" in conf["mode"]:
        start = time.time()
        res = mc.test()
        _, gt = common.load_mnist()
        print(f"Elapsed time: {time.time() - start:f}s")
        print(f"Training-set accuracy: {float((np.argmax(res, -1) == gt).mean()):.4f}")


if __name__ == "__main__":
    main()
