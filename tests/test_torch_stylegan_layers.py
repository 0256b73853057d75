"""ku_torch's StyleGAN layers against ku's, on the CPU.

The same numpy-made inputs and ku's params (carried across by
``state_dict_from_tree``, ``strict=True``) go through both packages; the
ku side runs under ``jax.jit``. Tolerance: f32, 1e-5 of the largest entry
of ku's output (sums in another order through one conv or product).

Each place where the two packages can part has its cases, which fail on
the wrong choice: the transposed conv (``lax.conv_transpose`` correlates
the dilated input with the kernel as stored; a kernel that is not
symmetric, a non-square input and in ≠ out channels), XLA's SAME padding
at stride 2 (an odd input pads (1, 2) with the fused 4×4 kernel), the
fan-in taken over all non-batch dims at call time, AdaIN's population σ
with ε added to σ, the flipped blur kernel (a blur that is not symmetric,
drawn by each package's own init), the 2× bilinear resize at the edges,
and the minibatch-stddev grouping over the channels-last layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import ku.nn as knn
from ku.initializers_ext import he_normal as ku_he_normal
from ku.nn import common as kcommon
from ku.nn import convolution as kconv
from ku_torch import nn as tnn
from ku_torch.initializers_ext import he_normal
from ku_torch.models.stylegan import upsample_bilinear_2x
from ku_torch.nn import common as tcommon
from ku_torch.nn import convolution as tconv
from ku_torch.utility import state_dict_from_tree

REL = 1e-5
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one torch thread is faster here and spares the other
    test workers the oversubscribed cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs diff {err} > {rel} x {scale}"


def _ku(module, x, **kw):
    """ku's init and jitted apply on x; returns (params, output)."""
    variables = jax.jit(module.init)(jax.random.key(0), x)
    out = jax.jit(lambda v, xx: module.apply(v, xx, **kw))(variables, x)
    return variables["params"], np.asarray(out)


def _load(module, params):
    module.load_state_dict(state_dict_from_tree(params, CPU), strict=True)
    return module


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- dense ---------------------------------------------------------------


@pytest.mark.parametrize("shape,features,kw", [
    ((3, 7), 5, {}),
    ((3, 7), 5, dict(activation="lrelu", lrmul=0.5, gain=1.0)),
    ((2, 4, 6), 3, dict(use_bias=False)),  # fan-in 24: every non-batch dim
])
def test_equalized_lr_dense(shape, features, kw):
    x = _x(shape)
    params, want = _ku(knn.EqualizedLRDense(features, **kw), jnp.asarray(x))
    layer = _load(tnn.EqualizedLRDense(shape[-1], features, device=CPU, **kw), params)
    _close(layer(_t(x)), want)


# -- convolutions -----------------------------------------------------------

CONV_CASES = {
    "1d valid": (knn.EqualizedLRConv1D, tnn.EqualizedLRConv1D, (2, 9, 3), 4, 3,
                 dict(padding="valid")),
    "1d fused same stride 2": (knn.FusedEqualizedLRConv1D, tnn.FusedEqualizedLRConv1D,
                               (2, 9, 3), 4, 3, dict(padding="same", strides=2)),
    "2d same non-square": (knn.EqualizedLRConv2D, tnn.EqualizedLRConv2D, (2, 6, 5, 3),
                           4, 3, dict(padding="same")),
    "2d 1x1 tanh": (knn.EqualizedLRConv2D, tnn.EqualizedLRConv2D, (2, 4, 4, 5), 3, 1,
                    dict(padding="same", activation="tanh")),
    "2d dilated": (knn.EqualizedLRConv2D, tnn.EqualizedLRConv2D, (1, 9, 8, 2), 3, 3,
                   dict(padding="same", dilation_rate=2, lrmul=0.25)),
    "2d explicit padding": (knn.EqualizedLRConv2D, tnn.EqualizedLRConv2D, (1, 6, 5, 2),
                            3, (2, 3), dict(padding=((1, 0), (2, 1)))),
    # The discriminator's downscale: the fused 4x4 kernel at stride 2, SAME
    # (1, 1) on an even map, (1, 2) on an odd one.
    "2d fused stride 2 even": (knn.FusedEqualizedLRConv2D, tnn.FusedEqualizedLRConv2D,
                               (2, 8, 6, 3), 5, 3, dict(padding="same", strides=2)),
    "2d fused stride 2 odd": (knn.FusedEqualizedLRConv2D, tnn.FusedEqualizedLRConv2D,
                              (2, 7, 5, 3), 5, 3, dict(padding="same", strides=2)),
    "3d same": (knn.EqualizedLRConv3D, tnn.EqualizedLRConv3D, (1, 4, 5, 3, 2), 3, 3,
                dict(padding="same")),
    "3d fused valid": (knn.FusedEqualizedLRConv3D, tnn.FusedEqualizedLRConv3D,
                       (1, 5, 4, 4, 2), 3, 2, dict(padding="valid")),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_equalized_lr_conv(case):
    ku_cls, port_cls, shape, filters, ksize, kw = CONV_CASES[case]
    x = _x(shape)
    params, want = _ku(ku_cls(filters, ksize, **kw), jnp.asarray(x))
    layer = _load(port_cls(shape[-1], filters, ksize, device=CPU, **kw), params)
    _close(layer(_t(x)), want)


@pytest.mark.parametrize("n,k,s", [(8, 4, 2), (7, 4, 2), (5, 3, 1), (6, 3, 2),
                                   (9, 5, 3), (4, 4, 1)])
def test_same_padding_is_xla_s(n, k, s):
    """Against XLA's own padding: the output of a VALID conv over the
    port's explicit pads equals a SAME conv."""
    x = jnp.asarray(_x((1, n, 1)))
    w = jnp.asarray(_x((k, 1, 1), seed=1))
    same = lax.conv_general_dilated(x, w, (s,), "SAME",
                                    dimension_numbers=("NWC", "WIO", "NWC"))
    explicit = lax.conv_general_dilated(x, w, (s,), [tconv.same_padding(n, k, s)],
                                        dimension_numbers=("NWC", "WIO", "NWC"))
    np.testing.assert_array_equal(np.asarray(same), np.asarray(explicit))


@pytest.mark.parametrize("rank,average", [(1, True), (2, True), (2, False), (3, True)])
def test_fuse_kernel(rank, average):
    k = _x((3,) * rank + (2, 4))
    _close(tconv._fuse_kernel(_t(k), rank, average),
           kconv._fuse_kernel(jnp.asarray(k), rank, average))


@pytest.mark.parametrize("ksize,strides,padding", [
    (4, 2, "SAME"),  # the generator's fused 2x upsample: pads (2, 2)
    (4, 2, "VALID"),
    (3, 2, "SAME"),
    (3, 1, "SAME"),
    ((4, 3), (2, 3), "SAME"),
    (5, 3, "VALID"),
    (4, 3, "SAME"),  # pads (3, 2): the output cropped
])
def test_conv_transpose2d(ksize, strides, padding):
    """``lax.conv_transpose`` with transpose_kernel=False, on a kernel that
    is not symmetric, a non-square input and in != out channels."""
    ks = tcommon.normalize_tuple(ksize, 2)
    x, w = _x((2, 5, 3, 3)), _x(ks + (3, 4), seed=1)
    want = lax.conv_transpose(jnp.asarray(x), jnp.asarray(w),
                              tcommon.normalize_tuple(strides, 2), padding,
                              dimension_numbers=("NHWC", "HWIO", "NHWC"))
    _close(tconv.conv_transpose2d(_t(x), _t(w), strides, padding), want)


@pytest.mark.parametrize("shape,kw", [
    ((2, 5, 3, 3), dict(strides=2, padding="same")),
    ((1, 4, 4, 2), dict(strides=2, padding="valid", lrmul=0.5)),
    ((1, 3, 5, 2), dict(strides=1, padding="same", activation="lrelu")),
])
def test_fused_conv2d_transpose(shape, kw):
    x = _x(shape)
    params, want = _ku(knn.FusedEqualizedLRConv2DTranspose(4, 3, **kw), jnp.asarray(x))
    layer = _load(tnn.FusedEqualizedLRConv2DTranspose(shape[-1], 4, 3, device=CPU, **kw),
                  params)
    _close(layer(_t(x)), want)


@pytest.mark.parametrize("blur,mult,strides,padding", [
    ((1, 2, 1), 1, 1, "same"),
    ((1, 2, 3), 1, 1, "same"),  # not symmetric: the stored kernel is flipped
    ((1, 3), 2, 1, "valid"),
    ((1, 2, 3), 1, 2, "same"),
])
def test_blur_depthwise_conv2d(blur, mult, strides, padding):
    """Each package's own init (the blur is drawn from no seed) and the
    forward; the bias and a frozen kernel take no gradient."""
    x = _x((2, 6, 5, 3))
    kw = dict(blur_kernel=blur, strides=strides, padding=padding, depth_multiplier=mult)
    params, want = _ku(knn.BlurDepthwiseConv2D(**kw), jnp.asarray(x))
    layer = tnn.BlurDepthwiseConv2D(3, device=CPU, **kw)
    _close(layer.kernel, params["kernel"], rel=1e-7)
    _close(layer(_t(x)), want)
    frozen = tnn.BlurDepthwiseConv2D(3, trainable=False, device=CPU, **kw)
    xt = _t(x).requires_grad_(True)
    frozen(xt).sum().backward()
    assert frozen.kernel.grad is None and frozen.bias.grad is None
    assert xt.grad is not None


def test_depthwise_and_separable_conv3d():
    x = _x((1, 5, 4, 6, 2))
    kw = dict(strides=(1, 2, 1), padding="same", depth_multiplier=2)
    params, want = _ku(knn.DepthwiseConv3D(3, activation="relu", **kw), jnp.asarray(x))
    layer = _load(tnn.DepthwiseConv3D(2, 3, activation="relu", device=CPU, **kw), params)
    _close(layer(_t(x)), want)
    params, want = _ku(knn.SeparableConv3D(5, 3, dilation_rate=2, padding="same",
                                           depth_multiplier=2), jnp.asarray(x))
    layer = _load(tnn.SeparableConv3D(2, 5, 3, dilation_rate=2, padding="same",
                                      depth_multiplier=2, device=CPU), params)
    _close(layer(_t(x)), want)


def test_conv_nd_grouped():
    x, w = _x((2, 7, 6, 4)), _x((3, 2, 2, 6), seed=1)
    want = kconv.conv_nd(jnp.asarray(x), jnp.asarray(w), (2, 1), "SAME", 2, (1, 2), groups=2)
    _close(tconv.conv_nd(_t(x), _t(w), (2, 1), "SAME", 2, (1, 2), groups=2), want)


# -- normalization and style -------------------------------------------------


@pytest.mark.parametrize("epsilon", [1e-7, 1e-8, 0.1])
def test_adaptive_in(epsilon):
    """Population σ (ddof 0) with ε added to σ: ε 0.1 on content of σ ~0.3
    tells σ + ε from sqrt(σ² + ε)."""
    c, s = 0.3 * _x((2, 4, 3, 5)), _x((2, 4, 3, 5), seed=1)
    ku_layer = knn.AdaptiveIN(epsilon=epsilon)
    want = jax.jit(lambda a, b: ku_layer.apply({}, [a, b]))(jnp.asarray(c), jnp.asarray(s))
    _close(tnn.AdaptiveIN(epsilon=epsilon)([_t(c), _t(s)]), want)


@pytest.mark.parametrize("epsilon", [1e-8, 0.1])
def test_adaptive_in_with_style(epsilon):
    c, s = 0.3 * _x((2, 4, 3, 5)), _x((2, 10), seed=1)
    ku_layer = knn.AdaptiveINWithStyle(epsilon=epsilon)
    want = jax.jit(lambda a, b: ku_layer.apply({}, [a, b]))(jnp.asarray(c), jnp.asarray(s))
    _close(tnn.AdaptiveINWithStyle(epsilon=epsilon)([_t(c), _t(s)]), want)


def test_pixel_norm():
    x = _x((3, 4, 2, 6))
    want = jax.jit(lambda a: knn.PixelNorm().apply({}, a))(jnp.asarray(x))
    _close(tnn.PixelNorm()(_t(x)), want)


@pytest.mark.parametrize("shape", [(2, 4, 4, 3), (1, 8, 8, 5), (2, 4, 6, 2)])
def test_bilinear_upsample_2x(shape):
    """jax.image.resize "bilinear" at 2x, edges included."""
    x = _x(shape)
    n, h, w, c = shape
    want = jax.jit(lambda a: jax.image.resize(a, (n, 2 * h, 2 * w, c), "bilinear"))(
        jnp.asarray(x))
    _close(upsample_bilinear_2x(_t(x)), want)


@pytest.mark.parametrize("n,group,features,hw", [
    (8, 4, 2, (3, 4)),  # sample j groups with j + 2k
    (4, 4, 1, (2, 2)),
    (2, 4, 1, (4, 3)),  # the group shrinks to the batch
    (6, 2, 3, (2, 3)),
])
def test_minibatch_stddev_concat(n, group, features, hw):
    x = _x((n,) + hw + (6,)) + np.arange(n, dtype=np.float32)[:, None, None, None]
    ku_layer = knn.MinibatchStddevConcat(group_size=group, num_new_features=features)
    want = jax.jit(lambda a: ku_layer.apply({}, a))(jnp.asarray(x))
    got = tnn.MinibatchStddevConcat(group_size=group, num_new_features=features)(_t(x))
    _close(got, want)


def test_style_mixing_regularization():
    d1, d2 = _x((3, 6, 4)), _x((3, 6, 4), seed=1)
    for prob, det in ((None, False), (0.9, True)):
        layer = tnn.StyleMixingRegularization(mixing_prob=prob)
        np.testing.assert_array_equal(layer([_t(d1), _t(d2)], deterministic=det).numpy(), d1)
    # The port's own draws: a cutoff in [1, num_layers) with probability
    # mixing_prob, else d1 throughout.
    layer = tnn.StyleMixingRegularization(mixing_prob=0.75)
    g = torch.Generator().manual_seed(0)
    ones, zeros = torch.ones(1, 6, 1), torch.zeros(1, 6, 1)
    cutoffs = []
    for _ in range(800):
        out = layer([ones, zeros], generator=g)[0, :, 0]
        cutoffs.append(int(out.sum()))
        assert torch.equal(out, (torch.arange(6) < cutoffs[-1]).float())
    cutoffs = np.array(cutoffs)
    assert set(cutoffs) == set(range(1, 7))
    assert abs((cutoffs < 6).mean() - 0.75) < 0.06


@pytest.mark.parametrize("deterministic,cutoff", [(True, 3), (False, 3), (False, None)])
def test_truncation_trick(deterministic, cutoff):
    """Training updates moving_mean from the layer-0 batch mean, then pulls
    toward the *updated* mean (ku's code, not its docstring)."""
    x = _x((4, 6, 5))
    ku_layer = knn.TruncationTrick(psi=0.7, cutoff=cutoff, momentum=0.9)
    variables = {"batch_stats": {"moving_mean": jnp.asarray(_x((5,), seed=2))}}
    apply = jax.jit(lambda v, a: ku_layer.apply(v, a, deterministic=deterministic,
                                                mutable=["batch_stats"]))
    want, mutated = apply(variables, jnp.asarray(x))
    layer = tnn.TruncationTrick(5, psi=0.7, cutoff=cutoff, momentum=0.9, device=CPU)
    layer.load_state_dict(state_dict_from_tree(variables["batch_stats"], CPU), strict=True)
    _close(layer(_t(x), deterministic=deterministic), want)
    _close(layer.moving_mean, mutated["batch_stats"]["moving_mean"])


# -- initializers and activations ------------------------------------------------


def test_he_normal_distribution():
    """Fan-in truncated normal: the same standard deviation as ku's draw
    and every value inside ±2 of the untruncated σ."""
    shape = (3, 3, 200, 50)
    w = he_normal(2.0)(shape, torch.Generator().manual_seed(0))
    ref = np.asarray(ku_he_normal(2.0)(jax.random.key(0), shape))
    assert abs(float(w.std()) / float(ref.std()) - 1.0) < 0.02
    sigma = np.sqrt(2.0 / (9 * 200)) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * sigma * (1 + 1e-6)
    assert abs(float(w.std()) - np.sqrt(2.0 / (9 * 200))) < 0.02 * np.sqrt(2.0 / (9 * 200))


@pytest.mark.parametrize("name", sorted(k for k in kcommon._ACTIVATIONS if k))
def test_activations(name):
    x = 3.0 * _x((4, 7))
    _close(tcommon.resolve_activation(name)(_t(x)),
           kcommon.resolve_activation(name)(jnp.asarray(x)))


def test_truncated_normal_init():
    w = tcommon.truncated_normal_init(0.5)((4000,), torch.Generator().manual_seed(0))
    assert float(w.abs().max()) <= 1.0
    assert abs(float(w.std()) - 0.5 * 0.87962566103423978) < 0.02
