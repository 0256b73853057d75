"""ku_torch's image utilities and PNG codec against ku's and matplotlib's, on
the CPU.

``resize`` / ``resize_batch`` against ku's ``jax.image.resize(...,
"linear")`` when enlarging, shrinking, and enlarging one axis while
shrinking the other, at atol 1e-6 (f32 sums of a few products). Shrinking
is where the trap lies: JAX widens its triangle kernel by the scale, and
torch does only with ``antialias=True`` (``antialias=False`` misses by
0.4 on these images, as test_downsampling_needs_antialias pins). The
letterbox, its pads and ``get_one_hot`` exactly (the letterbox's pixels at
1e-6). The PNG writer is read back by matplotlib and the reader reads
matplotlib's output, both to the bit.
"""

import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.image as mpimg  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from ku.image_utils import get_one_hot as ku_get_one_hot  # noqa: E402
from ku.image_utils import resize as ku_resize  # noqa: E402
from ku.image_utils import resize_batch as ku_resize_batch  # noqa: E402
from ku.image_utils import (  # noqa: E402
    resize_image_to_target_symmeric_size as ku_letterbox,
)
from ku_torch.image_utils import (  # noqa: E402
    get_one_hot,
    read_png,
    resize,
    resize_batch,
    resize_image_to_target_symmeric_size,
    write_png,
)

ATOL = 1e-6

# (in h, w) -> size=(out w, out h)
CASES = {
    "up": ((5, 7), (13, 11)),
    "down": ((37, 53), (16, 16)),
    "mixed": ((20, 9), (30, 8)),  # w 9 -> 30 up, h 20 -> 8 down
    "same": ((6, 6), (6, 6)),
}


def _image(hw, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    shape = hw + (3,) if batch is None else (batch,) + hw + (3,)
    return rng.uniform(size=shape).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_resize_matches_ku(case):
    hw, size = CASES[case]
    img = _image(hw)
    got = resize(img, size)
    want = np.asarray(ku_resize(img, size))
    assert tuple(got.shape) == want.shape == (size[1], size[0], 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # A tensor in, the same out.
    np.testing.assert_allclose(resize(torch.from_numpy(img), size).numpy(), want, rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_resize_batch_matches_ku(case):
    hw, size = CASES[case]
    imgs = _image(hw, seed=1, batch=3)
    got = resize_batch(imgs, size).numpy()
    want = np.asarray(ku_resize_batch(imgs, size))
    assert got.shape == want.shape == (3, size[1], size[0], 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_downsampling_needs_antialias():
    """Without antialiasing torch's bilinear shrink is another function."""
    img = _image((37, 53), seed=2)
    want = np.asarray(ku_resize(img, (16, 16)))
    plain = F.interpolate(torch.from_numpy(img).permute(2, 0, 1)[None], size=(16, 16),
                          mode="bilinear", align_corners=False, antialias=False)
    assert float(np.abs(plain[0].permute(1, 2, 0).numpy() - want).max()) > 0.05


@pytest.mark.parametrize("hw", [(30, 50), (50, 30), (40, 40), (33, 20)],
                         ids=["wide", "tall", "square", "tall_odd"])
def test_letterbox_matches_ku(hw):
    img = _image(hw, seed=3)
    got = resize_image_to_target_symmeric_size(img, 24)
    want = ku_letterbox(img, 24)
    assert got[1:] == tuple(int(v) for v in want[1:])
    assert tuple(got[0].shape) == np.asarray(want[0]).shape == (24, 24, 3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=ATOL)


def test_letterbox_tall_pads_in_kus_order():
    """A tall image pads (pad_r, pad_l) on the left and right, as ku does."""
    img = np.ones((30, 14, 1), np.float32)
    image_p, w, h, pad_t, pad_l, pad_b, pad_r = resize_image_to_target_symmeric_size(img, 20)
    assert (w, h, pad_t, pad_b) == (14, 30, 0, 0) and pad_r == pad_l + 1
    cols = image_p[..., 0].sum(dim=0).numpy()
    assert (cols[:pad_r] == 0).all() and (cols[20 - pad_l:] == 0).all()
    assert (cols[pad_r:20 - pad_l] > 0).all()


def test_get_one_hot_matches_ku():
    labels = np.array([[0, 2, 5], [-1, 3, 9]])[..., None]
    got = get_one_hot(labels, 4)
    want = np.asarray(ku_get_one_hot(labels, 4))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert got[0, 2, 0] == 1.0 and got[1, 0, 0] == 1.0  # out of range → class 0


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_writer_read_by_matplotlib(tmp_path, channels):
    rng = np.random.default_rng(channels)
    pixels = rng.integers(0, 256, size=(9, 14, channels), dtype=np.uint8)
    path = os.path.join(tmp_path, "w.png")
    write_png(path, pixels[..., 0] if channels == 1 else pixels)
    back = mpimg.imread(path)
    assert back.dtype == np.float32
    if channels == 2:  # gray + alpha comes back as RGBA
        back = back[..., [0, 3]]
    np.testing.assert_array_equal(np.rint(back * 255).astype(np.uint8).reshape(pixels.shape),
                                  pixels)
    np.testing.assert_array_equal(read_png(path).reshape(pixels.shape), pixels)


def test_png_writer_takes_floats_as_unit_range(tmp_path):
    img = np.array([[[0.0, 0.5, 1.0], [1.2, -0.1, 0.25]]], np.float32)
    path = os.path.join(tmp_path, "f.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), [[[0, 128, 255], [255, 0, 64]]])


@pytest.mark.parametrize("shape", [(17, 23, 3), (8, 5, 4), (12, 31)],
                         ids=["rgb", "rgba", "gray"])
def test_png_reader_on_matplotlib_output(tmp_path, shape):
    rng = np.random.default_rng(len(shape))
    img = rng.uniform(size=shape)
    path = os.path.join(tmp_path, "m.png")
    mpimg.imsave(path, img, cmap="gray" if len(shape) == 2 else None)
    want = np.rint(mpimg.imread(path) * 255).astype(np.uint8)
    np.testing.assert_array_equal(read_png(path), want)


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    from PIL import Image

    path = os.path.join(tmp_path, "p.png")
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(path)
    with pytest.raises(ValueError, match="color type 3"):
        read_png(path)
    Image.fromarray(np.zeros((4, 4), np.uint16) + 300).save(path)
    with pytest.raises(ValueError, match="bit depth 16"):
        read_png(path)
