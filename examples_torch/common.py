"""Shared example utilities: the repo root on ``sys.path``, and MNIST.

Port of ``examples/common.py``. ``load_mnist`` keeps the same order of
sources: Kaggle ``train.csv`` in ``data_dir``, then a cached Keras
``~/.keras/datasets/mnist.npz``, then sklearn's bundled 8×8 digits upscaled
to 28×28 by :func:`resize_linear` (``jax.image.resize``'s "linear" when
upsampling: half-pixel centres, the edges clamped).
"""

from __future__ import annotations

import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.nn import functional as F  # noqa: E402

KU_EXAMPLES = os.path.join(_REPO_ROOT, "examples")


def resize_linear(images: np.ndarray, size) -> np.ndarray:
    """(N, h, w) → (N, *size) by bilinear interpolation, in float32."""
    t = torch.from_numpy(np.ascontiguousarray(images, np.float32))[:, None]
    out = F.interpolate(t, size=tuple(size), mode="bilinear", align_corners=False,
                        antialias=False)
    return out[:, 0].numpy()


def load_mnist(flatten: bool = True, data_dir: str = "."):
    """Return (V, labels): V float32 in [0, 255], labels int64."""
    csv_path = os.path.join(data_dir, "train.csv")
    if os.path.exists(csv_path):
        table = np.loadtxt(csv_path, delimiter=",", skiprows=1, dtype=np.float32)
        labels = table[:, 0].astype(np.int64)
        V = table[:, 1:]
        if not flatten:
            V = V.reshape(-1, 28, 28, 1)
        return V, labels

    npz = os.path.expanduser("~/.keras/datasets/mnist.npz")
    if os.path.exists(npz):
        with np.load(npz) as d:
            x, y = d["x_train"], d["y_train"]
        V = x.astype(np.float32)
        V = V.reshape(-1, 784) if flatten else V[..., None]
        return V, y.astype(np.int64)

    from sklearn.datasets import load_digits

    d = load_digits()
    imgs = d.images.astype(np.float32) / 16.0 * 255.0  # (N, 8, 8) in [0, 255]
    imgs = resize_linear(imgs, (28, 28))
    V = imgs.reshape(-1, 784) if flatten else imgs[..., None]
    return V.astype(np.float32), d.target.astype(np.int64)


def write_solution(pred: np.ndarray, out_path: str) -> None:
    """Kaggle's ``solution.csv``: ``ImageId,Label``, one row per image."""
    with open(out_path, "w") as f:
        f.write("ImageId,Label\n")
        for i, label in enumerate(np.argmax(pred, axis=-1)):
            f.write(f"{i + 1},{int(label)}\n")
