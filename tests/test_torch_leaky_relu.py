"""Leaky ReLU's gradient at exactly 0 in the port, against ``jax.grad`` of
``ku``'s counterparts, on the CPU.

``jax.nn.leaky_relu`` is ``where(x >= 0, x, slope·x)``: its gradient at 0 is
1, where ``F.leaky_relu``'s is the slope. Each test makes exact-0
pre-activations (zero biases over a zero input, or hand-set 0 entries) in
one of the two places that use it: the ``"leaky_relu"`` / ``"lrelu"``
activations of ``ku_torch.nn.common`` (through ``EqualizedLRDense``) and the
StyleGAN models' ``_leaky`` (mapping net and discriminator). Gradients agree
within 1e-5 of the largest entry (f32 sums in another order); a slope of 0.2
at 0 parts them by 80 % of an entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ku.models import MappingNetwork as KuMapping
from ku.models import StyleGANDiscriminator as KuDisc
from ku.nn import EqualizedLRDense as KuEqDense
from ku.nn.common import resolve_activation as ku_activation
from ku_torch.models import MappingNetwork, StyleGANDiscriminator
from ku_torch.nn import EqualizedLRDense
from ku_torch.nn.common import resolve_activation
from ku_torch.utility import state_dict_from_tree, tree_from_state_dict

REL = 1e-5


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= REL * max(scale, 1e-30), f"{what}: max abs diff {err} > {REL} x {scale}"


def _grads_close(module, loss, ku_grads):
    """The port's gradients of ``loss`` in ``module``'s parameters against
    ``ku``'s gradient tree, name by name."""
    names = [n for n, _ in module.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in module.named_parameters()],
                                allow_unused=True, materialize_grads=True)
    got = tree_from_state_dict(dict(zip(names, grads)))
    flat = jax.tree_util.tree_leaves_with_path(ku_grads)
    assert len(flat) == len(names)
    for path, want in flat:
        node = got
        for p in path:
            node = node[p.key]
        _close(node, want, "/".join(p.key for p in path))


@pytest.mark.parametrize("name", ["leaky_relu", "lrelu"])
def test_activation_gradient_at_zero(name):
    x = np.array([0.0, -1.5, 2.0, 0.0, -0.0], np.float32)
    want = jax.grad(lambda v: ku_activation(name)(v).sum())(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(resolve_activation(name)(t).sum(), t)
    _close(got.numpy(), want, name)
    assert got[0] == 1.0 and got[3] == 1.0


@pytest.mark.parametrize("name", ["leaky_relu", "lrelu"])
def test_equalized_dense_activation_at_zero(name):
    """A zero input over the zero bias: every pre-activation is exactly 0."""
    rng = np.random.default_rng(0)
    x = np.zeros((3, 5), np.float32)
    w = rng.normal(size=(3, 4)).astype(np.float32)  # the loss's weights
    ku_layer = KuEqDense(4, activation=name)
    params = jax.jit(ku_layer.init)(jax.random.key(0), jnp.asarray(x))
    ku_grads = jax.grad(lambda p: (ku_layer.apply(p, jnp.asarray(x)) * w).sum())(params)
    port = EqualizedLRDense(5, 4, activation=name, device="cpu")
    port.load_state_dict(state_dict_from_tree(params["params"], "cpu"), strict=True)
    loss = (port(torch.from_numpy(x)) * torch.from_numpy(w)).sum()
    _grads_close(port, loss, ku_grads["params"])


def test_mapping_network_gradient_at_zero():
    """z = 0: pixel norm gives 0 and every dense layer's pre-activation is its
    zero bias, so each bias's gradient runs through leaky ReLU at 0 once per
    layer above it."""
    kw = dict(latent_dim=8, dlatent_dim=6, dense1_dim=8, num_mapping_layers=3,
              num_broadcast_layers=2, label_usage=False)
    z = np.zeros((2, 8), np.float32)
    w = np.random.default_rng(1).normal(size=(2, 2, 6)).astype(np.float32)
    ku_map = KuMapping(**kw)
    params = jax.jit(ku_map.init)(jax.random.key(0), jnp.asarray(z))
    ku_grads = jax.jit(jax.grad(
        lambda p: (ku_map.apply(p, jnp.asarray(z)) * w).sum()))(params)
    port = MappingNetwork(**kw, device="cpu")
    port.load_state_dict(state_dict_from_tree(params["params"], "cpu"), strict=True)
    loss = (port(torch.from_numpy(z)) * torch.from_numpy(w)).sum()
    _grads_close(port, loss, ku_grads["params"])


def test_discriminator_gradient_at_zero():
    """A zero image over zero biases: from_rgb's and the first convs'
    pre-activations are exactly 0."""
    conf = dict(resolution=8, ch_base=32, max_ch=8, label_usage=False)
    x = np.zeros((4, 8, 8, 3), np.float32)
    ku_disc = KuDisc(**conf)
    params = jax.jit(ku_disc.init)(jax.random.key(0), jnp.asarray(x))
    ku_grads = jax.jit(jax.grad(lambda p: ku_disc.apply(p, jnp.asarray(x)).sum()))(params)
    port = StyleGANDiscriminator(**conf, device="cpu")
    port.load_state_dict(state_dict_from_tree(params["params"], "cpu"), strict=True)
    _grads_close(port, port(torch.from_numpy(x)).sum(), ku_grads["params"])
