"""ku_torch's losses, gradient penalties and MeanIoUExt against ku's, on
the CPU.

Each loss takes the same numpy-made inputs in both packages (f32, rtol
1e-6 and atol 1e-7: one or two elementwise ops and a short sum). The
penalties go through a tiny StyleGAN discriminator (8 px) holding ku's
params: the penalty against ku's ``jax.grad`` of it, and the gradient of
the penalty with respect to the discriminator's params (the second order
that a GAN step takes) against ``jax.grad`` of ku's penalty, both within
1e-5 of the largest entry. ``MeanIoUExt`` is held against ku's over three
updates, accumulating and not, with and without sample weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ku.loss_ext.loss as kl
from ku.metrics_ext import MeanIoUExt as KuMeanIoU
from ku.models import StyleGANDiscriminator as KuDisc
import ku_torch.loss_ext.loss as tl
from ku_torch.metrics_ext import MeanIoUExt
from ku_torch.models import StyleGANDiscriminator
from ku_torch.utility import state_dict_from_tree, tree_from_state_dict

TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one torch thread is faster here and spares the other
    test workers the oversubscribed cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("name", ["wgan_loss", "softplus_loss", "softplus_inverse_loss",
                                  "lsgan_loss"])
def test_pointwise_losses(name):
    y_true, y_pred = _x((5, 3)), _x((5, 3), seed=1, scale=4.0)
    want = getattr(kl, name)(jnp.asarray(y_true), jnp.asarray(y_pred))
    got = getattr(tl, name)(torch.from_numpy(y_true), torch.from_numpy(y_pred))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("kw", [
    dict(num_classes=4),
    dict(num_classes=4, label_smoothing=0.2),
    dict(num_classes=4, from_logits=True),
    dict(num_classes=4, from_logits=True, label_smoothing=0.1),
    dict(num_classes=3),  # label 3 is out of range: a zero row, as jax.nn.one_hot
])
def test_categorical_crossentropy_with_label_gt(kw):
    labels = np.array([0, 3, 1, 2, 3])
    logits = _x((5, kw["num_classes"]), scale=3.0)
    y_pred = logits if kw.get("from_logits") else np.array(jax.nn.softmax(logits))
    if not kw.get("from_logits"):
        y_pred[0, 0] = 0.0  # clipped to EPSILON
    want = kl.categorical_crossentropy_with_label_gt(jnp.asarray(labels),
                                                     jnp.asarray(y_pred), **kw)
    got = tl.categorical_crossentropy_with_label_gt(torch.from_numpy(labels),
                                                    torch.from_numpy(y_pred), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    wrapped = tl.CategoricalCrossentropyWithLabelGT(**kw)(labels, torch.from_numpy(y_pred))
    np.testing.assert_allclose(float(wrapped), float(
        kl.CategoricalCrossentropyWithLabelGT(**kw)(labels, jnp.asarray(y_pred))), rtol=1e-6)


@pytest.mark.parametrize("cls", ["WGANLoss", "SoftPlusLoss", "SoftPlusInverseLoss"])
def test_loss_wrappers(cls):
    y_pred = _x((6, 2), scale=3.0)
    want = getattr(kl, cls)()(None, jnp.asarray(y_pred))
    got = getattr(tl, cls)()(None, torch.from_numpy(y_pred))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("wgan_gp_loss", dict(wgan_lambda=10.0, wgan_target=1.0)),
    ("wgan_gp_loss", dict(wgan_lambda=5.0, wgan_target=750.0)),
    ("r_penalty_loss", dict(r_gamma=10.0)),
    ("r_penalty_loss", dict(r_gamma=0.5)),
])
def test_penalties_from_gradients(name, kw):
    g = _x((3, 4, 4, 2))
    want = getattr(kl, name)(jnp.asarray(g), **kw)
    got = getattr(tl, name)(torch.from_numpy(g), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    wrap, kwrap = ((tl.WGANGPLoss, kl.WGANGPLoss) if name == "wgan_gp_loss"
                   else (tl.RPenaltyLoss, kl.RPenaltyLoss))
    np.testing.assert_allclose(float(wrap(**kw)(torch.from_numpy(g))),
                               float(kwrap(**kw)(jnp.asarray(g))), rtol=1e-6)


def _close(got, want, rel=1e-5):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, f"max abs diff {err} > {rel} x {scale}"


@pytest.mark.parametrize("penalty", ["r1_penalty", "gradient_penalty"])
def test_penalty_through_a_discriminator(penalty):
    """The penalty and its gradient in the discriminator's params against
    jax.grad through ku's discriminator."""
    conf = dict(resolution=8, ch_base=32, max_ch=8)
    x, label = _x((4, 8, 8, 3)), np.arange(1, 5, dtype=np.float32)[:, None]
    disc = KuDisc(**conf)
    params = jax.jit(disc.init)(jax.random.key(0), (jnp.asarray(x), jnp.asarray(label)))

    def ku_penalty(p, xx):
        return getattr(kl, penalty)(lambda v: disc.apply(p, (v, jnp.asarray(label))), xx)

    want = jax.jit(ku_penalty)(params, jnp.asarray(x))
    want_grads = jax.jit(jax.grad(lambda p, xx: ku_penalty(p, xx).sum()))(
        params, jnp.asarray(x))

    port = StyleGANDiscriminator(**conf, device="cpu")
    port.load_state_dict(state_dict_from_tree(params["params"], "cpu"), strict=True)
    xt = torch.from_numpy(x)
    got = getattr(tl, penalty)(lambda v: port((v, torch.from_numpy(label))), xt)
    assert not xt.requires_grad  # the caller's tensor is left as it was
    _close(got, want)
    got.sum().backward()
    grads = tree_from_state_dict({n: p.grad for n, p in port.named_parameters()
                                  if p.grad is not None})
    flat_want = {"/".join(str(k.key) for k in path): v for path, v in
                 jax.tree_util.tree_flatten_with_path(want_grads["params"])[0]}
    flat_got = {"/".join(str(k.key) for k in path): v for path, v in
                jax.tree_util.tree_flatten_with_path(grads)[0]}
    # A parameter that ∂D/∂x does not depend on (a bias after the last
    # nonlinearity, the blur's frozen bias) gets no gradient here, zeros in ku.
    for key, value in flat_want.items():
        if key not in flat_got:
            assert not np.any(value), key
            continue
        _close(torch.from_numpy(flat_got[key]), value, rel=1e-4)


def test_r1_penalty_of_a_tensor_in_the_graph():
    """x that already needs a gradient (a generator's output): the penalty's
    gradient reaches what made x."""
    w = torch.tensor(2.0, requires_grad=True)
    x = w * torch.from_numpy(_x((3, 2, 2, 1)))
    pen = tl.r1_penalty(lambda v: (0.7 * v.square()).sum(dim=(1, 2, 3)), x)
    expected = 10.0 * 0.5 * (4 * 0.49 * x.detach().square()).sum(dim=(1, 2, 3))
    torch.testing.assert_close(pen.detach(), expected)
    pen.sum().backward()
    assert w.grad is not None and float(w.grad) > 0


@pytest.mark.parametrize("accum,weighted,one_hot_truth", [
    (True, False, False), (True, True, True), (False, False, True), (False, True, False),
])
def test_mean_iou_ext(accum, weighted, one_hot_truth):
    rng = np.random.default_rng(0)
    ku_m, port_m = KuMeanIoU(4, accum_enable=accum), MeanIoUExt(4, accum_enable=accum)
    for _ in range(3):
        truth = rng.integers(0, 4, size=(5, 6))
        pred = np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=(5, 6))]
        pred += 0.1 * rng.random(pred.shape).astype(np.float32)
        y_true = np.eye(4, dtype=np.float32)[truth] if one_hot_truth else truth
        w = rng.random((5, 6)).astype(np.float32) if weighted else None
        want = ku_m(y_true, pred, w)
        got = port_m(torch.from_numpy(y_true), torch.from_numpy(pred),
                     None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_allclose(port_m.total_cm, ku_m.total_cm, rtol=1e-6)
    port_m.reset_state()
    assert not port_m.total_cm.any()
