"""Trained-artifact run: the class-conditional StyleGAN on digit images, in
torch, resumable after a kill.

Port of ``examples/style_based_gan/train_digits.py``, with its conf (32 px,
ch_base 2048, max_ch 256, batch 16, softplus-R1, 4 mapping layers, 10
classes):

1. Writes the digits (``examples_torch/common.load_mnist``: MNIST's files,
   sklearn's digits, or the seeded MNIST-like rows where neither is
   present) as RGB PNGs ordered so that the sorted file index modulo 10 is
   the digit: the example's pipeline takes its labels from the file index,
   so the class conditioning is the real label.
2. Trains through ``GAN.fit_generator`` with a sample grid, ``history.json``
   and a ``CheckpointCallback`` after every epoch, and
   ``initial_epoch="auto"``: kill the process at any point and run it again,
   and it goes on after the last complete epoch.
3. Writes the loss curve where matplotlib is present, the npz weights, and
   a grid of each class.

``ku``'s script probes for its accelerator and falls back to the CPU; this
one runs on the card unless ``--device cpu`` is given.

Usage, from the repository root: ``python examples_torch/style_based_gan/
train_digits.py [epochs] [batch_step] [--device cpu] [--run-dir DIR]
[--data-dir DIR] [--rows N]`` (defaults 30 × 64, directories beside this
file, every digit row).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(_HERE)))

import numpy as np  # noqa: E402

from examples_torch import common  # noqa: E402
from ku_torch.image_utils import write_png  # noqa: E402

CONF = {
    "mode": "train",
    "gan_mode": 2,  # softplus + R1
    "hps": {
        "epochs": 30, "batch_step": 64, "steps_per_call": 8, "disc_k_step": 1,
        "batch_size": 16, "mixing_prob": 0.9, "trunc_psi": 0.0, "trunc_cutoff": 4,
        "trunc_momentum": 0.99, "r_gamma": 10.0,
        "ch_base": 2048,  # ch at 4 px = min(2048 / 2^k, max_ch) → 256 at 32 px
        "max_ch": 256, "wgan_lambda": 10.0, "wgan_target": 1.0,
    },
    "nn_arch": {"label_usage": True, "lane_packing": True, "resolution": 32,
                "num_classes": 10},
    "map_nn_arch": {"latent_dim": 64, "dense1_dim": 64, "dlatent_dim": 64,
                    "num_classes": 10, "num_layers": 4},
    "disc_nn_arch": {"dropout_rate": 0.0},
    "disc_ext_hps": {"lr": 0.0015, "beta_1": 0.0, "beta_2": 0.99},
    "gen_disc_hps": {"lr": 0.0015, "beta_1": 0.0, "beta_2": 0.99},
}


def prepare_data(data_dir: str, rows=None):
    """Write the digit PNGs so that sorted-file-index % 10 is the label;
    ``rows`` caps their number (a multiple of 10)."""
    if os.path.isdir(data_dir) and len(os.listdir(data_dir)) > 100:
        return
    os.makedirs(data_dir, exist_ok=True)
    V, labels = common.load_mnist(flatten=False)
    V = np.asarray(V).reshape(len(V), 28, 28)
    by_class = [np.flatnonzero(labels == c) for c in range(10)]
    n = 10 * min(len(ix) for ix in by_class)
    if rows is not None:
        n = min(n, 10 * (int(rows) // 10))
    for i in range(n):
        img = np.clip(V[by_class[i % 10][i // 10]] / 255.0, 0.0, 1.0)
        write_png(os.path.join(data_dir, f"digit_{i:05d}.png"),
                  np.repeat(img[..., None], 3, axis=-1))
    print(f"[train_digits] wrote {n} PNGs to {data_dir}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("epochs", nargs="?", type=int, default=30)
    ap.add_argument("batch_step", nargs="?", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--run-dir", default=os.path.join(_HERE, "digits_run"))
    ap.add_argument("--data-dir", default=os.path.join(_HERE, "digits_data"))
    ap.add_argument("--rows", type=int, default=None)
    args = ap.parse_args(argv)
    run_dir = args.run_dir
    prepare_data(args.data_dir, args.rows)

    from examples_torch.style_based_gan.style_based_gan import StyleGAN, TrainingSequenceFFHQ
    from ku_torch.utils import CheckpointCallback, LambdaCallback

    conf = json.loads(json.dumps(CONF))  # a deep copy
    conf["raw_data_path"] = args.data_dir
    conf["hps"]["epochs"] = args.epochs
    conf["hps"]["batch_step"] = args.batch_step
    os.makedirs(os.path.join(run_dir, "samples"), exist_ok=True)
    hist_path = os.path.join(run_dir, "history.json")
    if os.path.exists(hist_path):
        with open(hist_path) as f:
            history = json.load(f)
    else:
        history = {"epoch": [], "disc_ext_loss": [], "gen_disc_loss": [], "wall_s": []}

    gan = StyleGAN(conf, device=args.device)
    seq = TrainingSequenceFFHQ(args.data_dir, conf["hps"], conf["nn_arch"],
                               conf["map_nn_arch"])
    # wall_s runs on across kills: continue from the last recorded value.
    t0 = time.time() - (history["wall_s"][-1] if history["wall_s"] else 0.0)

    def on_epoch_end(engine, epoch, logs):
        labels = np.arange(20).reshape(-1, 1) % 10  # two of each class
        imgs = gan.generate_samples(20, labels=labels, seed=7)
        gan._dump_samples(os.path.join(run_dir, "samples", f"epoch_{epoch + 1:04d}.npy"),
                          imgs=imgs)
        # A kill after this write and before the epoch's checkpoint makes the
        # resumed run repeat the epoch: its entry (and any later) goes first.
        keep = [i for i, e in enumerate(history["epoch"]) if e <= epoch]
        for key in history:
            history[key] = [history[key][i] for i in keep]
        history["epoch"].append(epoch + 1)
        history["disc_ext_loss"].append(float(logs["disc_ext_loss"]))
        history["gen_disc_loss"].append(float(logs["gen_disc_loss"]))
        history["wall_s"].append(round(time.time() - t0, 1))
        tmp = hist_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(history, f, indent=1)
        os.replace(tmp, hist_path)
        print(f"[train_digits] epoch {epoch + 1}/{args.epochs} "
              f"d={logs['disc_ext_loss']:.4f} g={logs['gen_disc_loss']:.4f} "
              f"({time.time() - t0:.0f}s)", flush=True)

    # The log is written before the checkpoint: a kill between the two
    # repeats the epoch, whose entry is then replaced (above), and no epoch
    # is checkpointed without its entry.
    callbacks = [LambdaCallback(on_epoch_end=on_epoch_end),
                 CheckpointCallback(os.path.join(run_dir, "ckpt"), every=1, max_to_keep=2)]
    gan.compile()
    gan.fit_generator(seq, verbose=0, seed=0, callbacks=callbacks, initial_epoch="auto")
    gan.save_gan_model(run_dir)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 4))
        ax.plot(history["epoch"], history["disc_ext_loss"], label="disc")
        ax.plot(history["epoch"], history["gen_disc_loss"], label="gen")
        ax.set_xlabel("epoch")
        ax.set_ylabel("loss")
        ax.legend()
        ax.set_title(f"StyleGAN digits 32px ({args.device})")
        fig.tight_layout()
        fig.savefig(os.path.join(run_dir, "loss_curve.png"), dpi=120)
    except ImportError as e:
        print(f"[train_digits] loss plot skipped: {e!r}")
    gan.evaluate(result_dir=os.path.join(run_dir, "per_class"), num_per_class=8,
                 classes=range(10))
    print(f"[train_digits] done: {len(history['epoch'])} epochs, artifacts in {run_dir}",
          flush=True)


if __name__ == "__main__":
    main()
