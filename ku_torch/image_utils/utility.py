"""Image preprocessing utilities (port of ``ku/image_utils/utility.py``).

- :func:`resize` / :func:`resize_batch`: bilinear resampling of HWC / NHWC
  images, ``F.interpolate(mode="bilinear", align_corners=False,
  antialias=True)``. That is ``jax.image.resize(..., "linear")``, half-pixel
  centres, in both directions: when it shrinks an axis, JAX widens the
  triangle kernel by the scale (it antialiases), and so does torch with
  ``antialias=True``; without it, torch samples the two nearest pixels
  only, which agrees with JAX only when enlarging. ``mode`` / ``device``
  are kept for ``ku``'s signature and change nothing: the work runs where
  the image lies (a numpy image on the CPU).
- :func:`resize_image_to_target_symmeric_size`: letterbox to a square, with
  ``ku``'s ``int()`` truncation of the scaled side and its (pad_r, pad_l)
  order for tall images.
- :func:`get_one_hot`: float64 one-hot of an (a, b, 1) label map; labels out
  of range become class 0.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

DEVICE_CPU = 0
DEVICE_GPU = 1  # kept for ku's signature; the work runs where the image lies


def _as_float_tensor(image) -> torch.Tensor:
    t = image if isinstance(image, torch.Tensor) else torch.from_numpy(np.asarray(image))
    return t if t.is_floating_point() else t.float()


def _resize_nhwc(images: torch.Tensor, h: int, w: int) -> torch.Tensor:
    x = images.permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(int(h), int(w)), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.permute(0, 2, 3, 1).contiguous()


def resize(image, size: tuple, mode: str = "constant", device: int = DEVICE_CPU):
    """An HWC image resized to ``size=(w, h)``, as a tensor."""
    w, h = size
    return _resize_nhwc(_as_float_tensor(image)[None], h, w)[0]


def resize_batch(images, size: tuple):
    """NHWC images resized to ``size=(w, h)`` in one call, as a tensor."""
    w, h = size
    return _resize_nhwc(_as_float_tensor(images), h, w)


def resize_image_to_target_symmeric_size(image, size: int, device: int = DEVICE_CPU):
    """Letterbox to a square of ``size``. Returns ``(image_p, w, h, pad_t,
    pad_l, pad_b, pad_r)``, ``ku``'s contract, its (pad_r, pad_l) left-right
    order for tall images included."""
    image = _as_float_tensor(image)
    h, w = int(image.shape[0]), int(image.shape[1])
    pad_t = pad_b = pad_l = pad_r = 0
    if w >= h:
        w_p, h_p = size, int(h / w * size)
        pad = size - h_p
        pad_t, pad_b = pad // 2, pad // 2 + (pad % 2)
        image_p = F.pad(resize(image, (w_p, h_p)), (0, 0, 0, 0, pad_t, pad_b))
    else:
        h_p, w_p = size, int(w / h * size)
        pad = size - w_p
        pad_l, pad_r = pad // 2, pad // 2 + (pad % 2)
        image_p = F.pad(resize(image, (w_p, h_p)), (0, 0, pad_r, pad_l))
    return image_p, w, h, pad_t, pad_l, pad_b, pad_r


def get_one_hot(inputs, num_classes: int) -> np.ndarray:
    """One-hot an (a, b, 1) label map to (a, b, num_classes), float64;
    labels outside [0, num_classes) become class 0."""
    labels = np.asarray(inputs)[..., 0].astype(np.int64)
    labels = np.where((labels >= 0) & (labels < num_classes), labels, 0)
    return np.eye(num_classes, dtype=np.float64)[labels]
