"""The NobodyConvNet backbones (ku_torch.applications_ext) against ku's, on
the CPU, block by block.

Each block of both backbones (``Block3`` and ``Module6`` included, which no
call path reaches) is built in both packages under the same flax names;
ku's variables, with the BatchNorm scales, biases and running statistics
drawn away from their initial ones, load strictly into the port's module
through ``load_variables``. Inference and training mode (batch statistics)
are compared: outputs within 1e-5 of their largest entry, the updated
``batch_stats`` within 1e-6. ku's side runs under ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ku.applications_ext import nobody_convnet2d as ku2d
from ku.applications_ext import nobody_convnet3d as ku3d
from ku.applications_ext import _modules as ku_modules
from ku_torch.applications_ext import NobodyConvNet2D, NobodyConvNet3D
from ku_torch.applications_ext import _modules as pt_modules
from ku_torch.applications_ext import nobody_convnet2d as pt2d
from ku_torch.applications_ext import nobody_convnet3d as pt3d
from ku_torch.utility import load_variables, variables_from_module

REL, STATS_REL = 1e-5, 1e-6
CPU = "cpu"
MNIST_CONF = {"hps": {"bn_momentum": 0.9}, "nn_arch": {"sp_feature_dim": 32,
                                                       "conv_rate_multiplier": 1}}


def _drawn(variables, seed):
    """ku's variables with every BatchNorm leaf drawn away from its initial
    value (scale near 1, bias and mean near 0, var in [0.5, 1.5])."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = str(path[-1].key)
        v = np.asarray(v)
        if name == "scale":
            return (1.0 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.2 * rng.standard_normal(v.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return v

    return jax.tree_util.tree_map_with_path(leaf, jax.tree.map(np.asarray, variables))


def _close(got, want, rel, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, f"{what}: max abs diff {err} > {rel} x {scale}"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _check(ku_module, port_module, inputs, seed=0, stats_rel=STATS_REL):
    """Init ku's module on ``inputs``, load its drawn variables into the
    port's, and compare both modes."""
    ku_in = jax.tree.map(jnp.asarray, inputs)
    pt_in = (torch.from_numpy(inputs) if isinstance(inputs, np.ndarray)
             else [torch.from_numpy(a) for a in inputs])
    variables = _drawn(jax.jit(ku_module.init)(jax.random.key(seed), ku_in), seed)
    load_variables(port_module, variables)

    @jax.jit
    def both_modes(v, x):
        return (ku_module.apply(v, x, deterministic=True),
                ku_module.apply(v, x, deterministic=False, mutable=["batch_stats"]))

    infer, (want, updates) = both_modes(variables, ku_in)
    with torch.no_grad():
        _close(port_module(pt_in, deterministic=True), infer, REL, "inference")
        got = port_module(pt_in, deterministic=False)
    _close(got, want, REL, "training")
    if "batch_stats" in variables:
        g = _flat(variables_from_module(port_module)["batch_stats"])
        w = _flat(jax.tree.map(np.asarray, updates["batch_stats"]))
        assert g.keys() == w.keys()
        for k in w:
            _close(g[k], w[k], stats_rel, f"batch_stats/{k}")


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


KW = dict(device=CPU, generator=None)

# (name, ku module, port module, input) for each block; C the input channels.
_C2, _C3 = 3, 2
BLOCKS_2D = {
    "ConvBNAct": (lambda: ku_modules.ConvBNAct(2, 5, strides=2, dilation=1, bn_momentum=0.9),
                  lambda: pt_modules.ConvBNAct(2, _C2, 5, strides=2, bn_momentum=0.9, **KW),
                  (2, 7, 9, _C2)),
    "DepthwiseBNAct": (lambda: ku_modules.DepthwiseBNAct(2, depth_multiplier=2, dilation=2),
                       lambda: pt_modules.DepthwiseBNAct(2, _C2, depth_multiplier=2,
                                                         dilation=2, **KW),
                       (2, 7, 7, _C2)),
    "SepConvBNAct": (lambda: ku_modules.SepConvBNAct(2, 6, strides=2, bn_momentum=0.9),
                     lambda: pt_modules.SepConvBNAct(2, _C2, 6, strides=2, bn_momentum=0.9,
                                                     **KW),
                     (2, 7, 7, _C2)),
    "Module1": (lambda: ku2d.Module1(4), lambda: pt2d.Module1(_C2, 4, **KW), (2, 7, 7, _C2)),
    "Module2": (lambda: ku2d.Module2(4, rate=2), lambda: pt2d.Module2(_C2, 4, rate=2, **KW),
                (2, 6, 6, _C2)),
    "Module3": (lambda: ku2d.Module3(8), lambda: pt2d.Module3(_C2, 8, **KW), (2, 6, 6, _C2)),
    "Module4": (lambda: ku2d.Module4(4), lambda: pt2d.Module4(_C2, 4, **KW),
                [(2, 6, 6, _C2), (2, 1, 1, _C2)]),
    "Module5": (lambda: ku2d.Module5(7), lambda: pt2d.Module5(_C2, 7, **KW), (2, 6, 6, _C2)),
    "Module6": (lambda: ku2d.Module6(4), lambda: pt2d.Module6(_C2, 4, **KW), (2, 3, 5, _C2)),
    "Module7": (lambda: ku2d.Module7(4), lambda: pt2d.Module7(_C2, 4, **KW),
                [(2, 6, 6, _C2), (2, 6, 6, _C2)]),
    "Block1": (lambda: ku2d.Block1(4, bn_momentum=0.9),
               lambda: pt2d.Block1(_C2, 4, bn_momentum=0.9, **KW), (2, 9, 9, _C2)),
    "Block2": (lambda: ku2d.Block2(_C2), lambda: pt2d.Block2(_C2, _C2, **KW), (2, 6, 6, _C2)),
    "Block3": (lambda: ku2d.Block3(4), lambda: pt2d.Block3(_C2, 4, **KW), (2, 3, 3, _C2)),
}
BLOCKS_3D = {
    "ConvBNAct": (lambda: ku_modules.ConvBNAct(3, 4, strides=2, padding="valid"),
                  lambda: pt_modules.ConvBNAct(3, _C3, 4, strides=2, padding="valid", **KW),
                  (1, 7, 6, 5, _C3)),
    "SepConvBNAct": (lambda: ku_modules.SepConvBNAct(3, 5, dilation=2),
                     lambda: pt_modules.SepConvBNAct(3, _C3, 5, dilation=2, **KW),
                     (1, 6, 6, 6, _C3)),
    "Module1": (lambda: ku3d.Module1(4), lambda: pt3d.Module1(_C3, 4, **KW),
                (1, 5, 5, 5, _C3)),
    "Module2": (lambda: ku3d.Module2(6), lambda: pt3d.Module2(_C3, 6, **KW),
                (1, 7, 7, 7, _C3)),
    "Module3": (lambda: ku3d.Module3(6), lambda: pt3d.Module3(_C3, 6, **KW),
                (1, 4, 4, 4, _C3)),
    "Module4": (lambda: ku3d.Module4(4), lambda: pt3d.Module4(_C3, 4, **KW),
                [(1, 4, 4, 4, _C3), (1, 1, 1, 1, _C3)]),
    "Module5": (lambda: ku3d.Module5(3), lambda: pt3d.Module5(_C3, 3, **KW),
                (1, 4, 4, 4, _C3)),
    "Module6": (lambda: ku3d.Module6(3), lambda: pt3d.Module6(_C3, 3, **KW),
                (1, 2, 3, 2, _C3)),
    "Module7": (lambda: ku3d.Module7(3), lambda: pt3d.Module7(_C3, 3, **KW),
                [(1, 4, 4, 4, _C3), (1, 1, 1, 1, _C3)]),
    "Block1": (lambda: ku3d.Block1(4), lambda: pt3d.Block1(_C3, 4, **KW), (1, 9, 9, 9, _C3)),
    "Block2": (lambda: ku3d.Block2(4), lambda: pt3d.Block2(_C3, 4, **KW), (1, 7, 7, 7, _C3)),
    # Block3 adds Module6's 2s-map to Module2's VALID stride-2 output, which
    # broadcasts only at s = 2 (the output is then 1×1×1).
    "Block3": (lambda: ku3d.Block3(4), lambda: pt3d.Block3(_C3, 4, **KW), (1, 2, 2, 2, _C3)),
}


def _inputs(shape):
    if isinstance(shape, list):
        return [_x(s, seed=1 + i) for i, s in enumerate(shape)]
    return _x(shape)


@pytest.mark.parametrize("name", sorted(BLOCKS_2D))
def test_2d_block_matches_ku(name):
    make_ku, make_port, shape = BLOCKS_2D[name]
    _check(make_ku(), make_port(), _inputs(shape))


@pytest.mark.parametrize("name", sorted(BLOCKS_3D))
def test_3d_block_matches_ku(name):
    make_ku, make_port, shape = BLOCKS_3D[name]
    _check(make_ku(), make_port(), _inputs(shape))


def test_nobody_convnet2d_at_the_mnist_conf():
    """The whole backbone at the MNIST example's conf: ku's tree, 16,721
    parameters, the (B, 7, 7, 32) output, both modes."""
    x = _x((2, 28, 28, 1)) * 50.0
    ku_model = ku2d.NobodyConvNet2D.from_conf(MNIST_CONF, x.shape)
    port = NobodyConvNet2D.from_conf(MNIST_CONF, x.shape, device=CPU)
    assert [n for n, _ in port.named_children()] == [
        "SepConvBNAct_0", "Block1_0", "Block2_0", "Block2_1", "Block2_2", "Module5_0"]
    assert sum(p.numel() for p in port.parameters()) == 16721
    _check(ku_model, port, x)
    assert port(torch.from_numpy(x)).shape == (2, 7, 7, 32)


def test_nobody_convnet3d_depth_2():
    """Depth 2 at the smallest volume it takes (21³: 21 → 11 → 5 → 3 → 1).
    The deepest statistics are means over activations held at REL, so they
    are held at REL too."""
    x = _x((1, 21, 21, 21, 1))
    ku_model = ku3d.NobodyConvNet3D.from_conf(MNIST_CONF, x.shape, depth=2)
    port = NobodyConvNet3D.from_conf(MNIST_CONF, x.shape, depth=2, device=CPU)
    assert [n for n, _ in port.named_children()] == [
        "SepConvBNAct_0", "Block1_0", "Block1_1", "Module5_0"]
    _check(ku_model, port, x, stats_rel=REL)
    assert port(torch.from_numpy(x)).shape == (1, 1, 1, 1, 32)


def test_init_draws_like_ku():
    """Kernels from a normal at stddev 0.05 cut at ±2σ, BN at ones and
    zeros, statistics at zeros and ones, no conv bias; the same shapes as
    ku's tree."""
    x = _x((2, 28, 28, 1))
    port = NobodyConvNet2D.from_conf(MNIST_CONF, x.shape, device=CPU,
                                     generator=torch.Generator().manual_seed(0))
    ku_vars = jax.eval_shape(ku2d.NobodyConvNet2D.from_conf(MNIST_CONF, x.shape).init,
                             jax.random.key(0), jnp.asarray(x))
    got = variables_from_module(port)
    for col in ("params", "batch_stats"):
        g, w = _flat(got[col]), _flat(ku_vars[col])
        assert {k: v.shape for k, v in g.items()} == {k: v.shape for k, v in w.items()}
    kernels = np.concatenate([v.ravel() for k, v in _flat(got["params"]).items()
                              if k.endswith("kernel")])
    assert np.abs(kernels).max() <= 0.1 + 1e-7
    assert abs(kernels.std() - 0.05 * 0.8796) < 0.003  # the ±2σ cut's std
