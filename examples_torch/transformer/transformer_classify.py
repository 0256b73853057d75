"""Transformer sequence classification (duplicate-of-first task), in torch.

Port of ``examples/transformer/transformer_classify.py``: ``Embed →
PeriodicPositionEncoding → N × Transformer → Dense(2)`` on position 0,
trained through the port's ``Trainer`` with Adam on the softmax
cross-entropy. Label 1 iff the first token appears again later in the
sequence, which pooling cannot solve: the model has to compare positions
with position 0.

Its conf, ``transformer_classify_conf.json`` beside it, is ku's with
``use_flash`` on, so that on the card the attention trains through the
flash kernels (``ku_torch.kernels.flash_attention``: the forward, and dq
and dk/dv in the backward); on the CPU their plain versions run.

Run from the repository root: ``python examples_torch/transformer/
transformer_classify.py [conf] [--device cpu] [--epochs N]`` (the card by
default; ``--epochs`` overrides the conf's).
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
import torch.nn.functional as F  # noqa: E402

from ku_torch.core.config import load_config  # noqa: E402
from ku_torch.engine_ext import Trainer, adam  # noqa: E402
from ku_torch.nn import Dense, PeriodicPositionEncoding, Transformer  # noqa: E402

CONF_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "transformer_classify_conf.json")


def make_dataset(n: int, seq_len: int, vocab: int, seed: int = 0):
    """Label 1 iff tokens[0] appears again in tokens[1:]; balanced."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, vocab, size=(n, seq_len))
    y = np.zeros((n,), np.int32)
    half = n // 2
    # Positive half: plant a copy of token 0 at a random later position.
    pos = rng.integers(1, seq_len, size=half)
    x[np.arange(half), pos] = x[np.arange(half), 0]
    y[:half] = 1
    # Negative half: remove accidental duplicates of the first token.
    for i in range(half, n):
        dup = x[i, 1:] == x[i, 0]
        x[i, 1:][dup] = (x[i, 1:][dup] % (vocab - 2)) + 1
        if (x[i, 1:] == x[i, 0]).any():  # wrapped onto the token itself
            x[i, 0] = vocab - 1 if x[i, 0] != vocab - 1 else 1
        y[i] = int((x[i, 1:] == x[i, 0]).any())
    perm = rng.permutation(n)
    return x[perm], y[perm]


class TransformerClassifier(torch.nn.Module):
    """ku's ``TransformerClassifier`` under its names: ``embed.weight`` is
    flax's ``embed/embedding``, the blocks ``block_{i}``, the readout
    ``head``."""

    def __init__(self, vocab: int = 32, seq_len: int = 24, d_model: int = 32,
                 num_head: int = 4, num_blocks: int = 2, dropout_rate: float = 0.0,
                 use_flash: bool = False, *, device="cuda", seed: int = 0):
        super().__init__()
        g = torch.Generator(device=device).manual_seed(seed)
        self.embed = torch.nn.Embedding(vocab, d_model, device=device)
        with torch.no_grad():  # flax Embed default: N(0, 1/d_model)
            self.embed.weight.normal_(0.0, 1.0 / np.sqrt(d_model), generator=g)
        self.pe = PeriodicPositionEncoding(seq_len, d_model, device=device)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block_{i}", Transformer(
                num_head, d_model, dropout_rate, use_flash=use_flash, device=device,
                generator=g))
        self.head = Dense(d_model, 2, device=device, generator=g)

    def forward(self, tokens, deterministic: bool = True):
        x = self.pe(self.embed(tokens.long()))
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")([x], deterministic=deterministic)
        # Position-0 readout (see module docstring).
        return self.head(x[:, 0])


def softmax_xent(y_true, logits):
    return F.cross_entropy(logits, y_true.long(), reduction="none")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("conf", nargs="?", default=CONF_PATH)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--epochs", type=int, default=None)
    args = parser.parse_args(argv)
    conf = load_config(args.conf)
    hps, arch = conf["hps"], conf["nn_arch"]
    epochs = int(hps["epochs"] if args.epochs is None else args.epochs)

    x_train, y_train = make_dataset(int(hps.get("num_train", 8192)),
                                    int(arch["seq_len"]), int(arch["vocab"]), seed=0)
    x_test, y_test = make_dataset(2048, int(arch["seq_len"]), int(arch["vocab"]), seed=1)
    model = TransformerClassifier(
        vocab=int(arch["vocab"]), seq_len=int(arch["seq_len"]),
        d_model=int(arch["d_model"]), num_head=int(arch["num_head"]),
        num_blocks=int(arch.get("num_blocks", 2)),
        dropout_rate=float(arch.get("dropout_rate", 0.0)),
        use_flash=bool(arch.get("use_flash", False)), device=args.device)
    trainer = Trainer(model, softmax_xent, optimizer=adam(float(hps["lr"])),
                      rng_streams=("dropout",))
    start = time.time()
    history = trainer.fit(x_train, y_train, batch_size=int(hps["batch_size"]),
                          epochs=epochs, verbose=1)
    logits = trainer.predict(x_test)
    acc = float((logits.argmax(-1) == y_test).mean())
    print(f"test accuracy: {acc:.4f}")
    print(f"Elasped time: {time.time() - start:f}s")
    return acc, history


if __name__ == "__main__":
    main()
