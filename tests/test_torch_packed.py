"""``ku_torch.nn.packed`` against ``ku.nn.packed`` on the CPU, and each packed
op against its unpacked counterpart in the port (as ``tests/test_packed.py``
holds ``ku``'s against XLA's).

Same inputs from a numpy seed on both sides, f32. Tolerances: the layout
moves (space_to_depth, depth_to_space, tiling, the kernel scatter) are exact;
convolutions and reductions agree within rtol/atol 1e-5 (AdaIN 1e-4 / 1e-5,
its division by a small σ), float32 sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

import ku.nn.packed as kp
import ku_torch.nn.packed as pp
from ku_torch.nn.convolution import conv_nd, conv_transpose_nd
from ku_torch.nn.normalization import AdaptiveINWithStyle, pixel_norm

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _both(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return _t(x), jnp.asarray(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def test_constants_and_layout_moves(rng):
    assert (pp.P, pp.PHASES) == (kp.P, kp.PHASES)
    x, xj = _both(rng, 2, 8, 12, 5)
    xp = pp.space_to_depth(x)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(kp.space_to_depth(xj)))
    assert torch.equal(pp.depth_to_space(xp), x)
    np.testing.assert_array_equal(pp.depth_to_space(xp).numpy(),
                                  np.asarray(kp.depth_to_space(kp.space_to_depth(xj))))
    assert torch.equal(xp[0, 0, 0, 10:15], x[0, 1, 0])  # phase (1, 0)
    v, vj = _both(rng, 5)
    np.testing.assert_array_equal(pp.tile_channels(v).numpy(), np.asarray(kp.tile_channels(vj)))
    vb, vbj = _both(rng, 3, 5)
    np.testing.assert_array_equal(pp.tile_channels_batched(vb).numpy(),
                                  np.asarray(kp.tile_channels_batched(vbj)))
    with pytest.raises(ValueError, match="even H and W"):
        pp.space_to_depth(torch.zeros(1, 3, 4, 2))


CONVS = [(1, 1), (3, 1), (3, 2), (4, 2), (5, 1)]


@pytest.mark.parametrize("k,s", CONVS)
def test_packed_conv2d(rng, k, s):
    """The scattered kernel and its pads bit for bit, the packed conv against
    ku's and against the unpacked SAME conv."""
    x, xj = _both(rng, 2, 8, 12, 3)
    w, wj = _both(rng, k, k, 3, 4)
    wp, pads = pp.pack_conv2d_kernel(w, s)
    wp_ku, pads_ku = kp.pack_conv2d_kernel(wj, s)
    np.testing.assert_array_equal(wp.numpy(), np.asarray(wp_ku))
    assert pads == pads_ku
    got = pp.packed_conv2d(pp.space_to_depth(x), w, s)
    _close(got, kp.packed_conv2d(kp.space_to_depth(xj), wj, s))
    _close(pp.depth_to_space(got), conv_nd(x, w, s, "SAME", 2))


def test_packed_conv2d_gradients(rng):
    """Gradients reach the original kernel's shape: against jax.grad of ku's
    packed conv."""
    x, xj = _both(rng, 2, 8, 8, 3)
    w, wj = _both(rng, 3, 3, 3, 4)
    g, gj = _both(rng, 2, 2, 2, 16)
    x.requires_grad_(), w.requires_grad_()
    got = torch.autograd.grad((pp.packed_conv2d(pp.space_to_depth(x), w, 2) * g).sum(),
                              (x, w))
    want = jax.grad(lambda a, b: (kp.packed_conv2d(kp.space_to_depth(a), b, 2) * gj).sum(),
                    argnums=(0, 1))(xj, wj)
    for a, b in zip(got, want):
        _close(a, b)


def test_packed_depthwise_conv2d(rng):
    x, xj = _both(rng, 2, 8, 8, 5)
    kd, kdj = _both(rng, 3, 3, 5, 1)
    got = pp.packed_depthwise_conv2d(pp.space_to_depth(x), kd)
    _close(got, kp.packed_depthwise_conv2d(kp.space_to_depth(xj), kdj))
    want = conv_nd(x, kd.reshape(3, 3, 1, 5), 1, "SAME", 2, groups=5)
    _close(pp.depth_to_space(got), want)
    with pytest.raises(ValueError, match="depth_multiplier=1"):
        pp.packed_depthwise_conv2d(pp.space_to_depth(x), torch.zeros(3, 3, 5, 2))


def test_packed_conv_transpose2x(rng):
    x, xj = _both(rng, 2, 8, 8, 3)
    w, wj = _both(rng, 4, 4, 3, 5)
    got = pp.packed_conv_transpose2x(pp.space_to_depth(x), w)
    assert got.shape == (2, 8, 8, 20)
    _close(got, kp.packed_conv_transpose2x(kp.space_to_depth(xj), wj))
    _close(pp.depth_to_space(got), conv_transpose_nd(x, w, 2, "SAME", 2))


def test_packed_norms_and_pool(rng):
    x, xj = _both(rng, 2, 8, 8, 6)
    xp, xpj = pp.space_to_depth(x), kp.space_to_depth(xj)
    got = pp.packed_pixel_norm(xp)
    _close(got, kp.packed_pixel_norm(xpj))
    _close(pp.depth_to_space(got), pixel_norm(x))
    for a, b in zip(pp.packed_instance_stats(xp), kp.packed_instance_stats(xpj)):
        _close(a, b)
    s, sj = _both(rng, 2, 12)
    got = pp.packed_adain_with_style(xp, s)
    _close(got, kp.packed_adain_with_style(xpj, sj), rtol=1e-4, atol=1e-5)
    _close(pp.depth_to_space(got), AdaptiveINWithStyle(epsilon=1e-7)([x, s]),
           rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="does not fit"):
        pp.packed_adain_with_style(xp, s[:, :6])
    got = pp.packed_avg_pool2x(xp)
    _close(got, kp.packed_avg_pool2x(xpj))
    _close(got, F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1))
