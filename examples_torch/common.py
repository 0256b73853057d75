"""Shared example utilities: the repo root on ``sys.path``, and MNIST.

Port of ``examples/common.py``. ``load_mnist`` keeps the same order of
sources: Kaggle ``train.csv`` in ``data_dir``, then a cached Keras
``~/.keras/datasets/mnist.npz``, then sklearn's bundled 8×8 digits upscaled
to 28×28 by :func:`resize_linear` (``ku_torch.image_utils.resize_batch``,
``jax.image.resize``'s "linear"). Where sklearn is absent too, it says so
and returns :func:`mnist_like`'s seeded rows.
"""

from __future__ import annotations

import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

KU_EXAMPLES = os.path.join(_REPO_ROOT, "examples")


def resize_linear(images: np.ndarray, size) -> np.ndarray:
    """(N, h, w) → (N, *size) by bilinear interpolation, in float32."""
    from ku_torch.image_utils import resize_batch

    t = torch.from_numpy(np.ascontiguousarray(images, np.float32))[..., None]
    return resize_batch(t, (size[1], size[0]))[..., 0].numpy()


def mnist_like(n: int = 60032, seed: int = 0):
    """Seeded MNIST-like rows, (V, labels): 28×28 binary images in {0, 255}
    (float32, about 13 % of pixels on, as in MNIST), each drawn pixel by
    pixel from its class's smooth prototype, so that the labels (int64,
    0-9) can be learned. For machines with neither MNIST nor sklearn."""
    rng = np.random.default_rng(seed)
    coarse = rng.normal(size=(10, 7, 7)).astype(np.float32)
    protos = resize_linear(coarse, (28, 28)).reshape(10, 784)
    # A logistic of each prototype, shifted so that 13 % of pixels are on.
    probs = 1.0 / (1.0 + np.exp(-(3.0 * protos - 3.0)))
    labels = rng.integers(0, 10, size=n)
    V = (rng.random((n, 784), dtype=np.float32) < probs[labels]).astype(np.float32) * 255.0
    return V, labels.astype(np.int64)


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

    try:
        from sklearn.datasets import load_digits
    except ImportError:
        print("[common] no MNIST files and no sklearn: seeded MNIST-like rows (mnist_like)")
        V, labels = mnist_like()
        return (V if flatten else V.reshape(-1, 28, 28, 1)), labels

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
