"""The rest of ku's surface in the port, on the CPU.

- ``ku_torch.backend_ext`` against ``ku.backend_ext``: ``pad`` in every
  mode at ranks 1–4 (numpy-style pairs, pads past a dim's size included
  for the mirror modes), ``transpose``, both forms of ``where``, ``cond``,
  ``broadcast_to``, ``add_n``, ``MultivariateNormalDiag.log_prob`` and its
  sample moments (the draws come from a ``torch.Generator`` where ku takes a
  key).
- Name parity: every public name of ``ku``, of each of its subpackages and
  of each of its modules exists at the same place in ``ku_torch``
  (``ku.pallas`` is ``ku_torch.kernels``); the list of exceptions still to
  port, ``NOT_PORTED``, is empty.
"""

import importlib
import importlib.util
import inspect
import pkgutil
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ku
import ku.backend_ext as kb
import ku_torch
import ku_torch.backend_ext as pb

# Not ported yet: nothing. Each entry would name a ku module and the names
# the port lacks (None: the whole module), and shrink as they came.
NOT_PORTED = {}


def _port_name(name: str) -> str:
    name = "ku_torch" + name[len("ku"):]
    return name.replace("ku_torch.pallas", "ku_torch.kernels", 1)


def _modules():
    """ku's subpackages and its Python modules (not built libraries)."""
    pkgs, mods = [], []
    for mi in pkgutil.walk_packages(ku.__path__, "ku."):
        spec = importlib.util.find_spec(mi.name)
        if mi.ispkg:
            pkgs.append(mi.name)
        elif spec.origin and spec.origin.endswith(".py"):
            mods.append(mi.name)
    return pkgs, mods


PACKAGES, MODULES = _modules()


def _package_names(pkg):
    """A package's public attributes: names it exports, not modules, and the
    subpackages its ``__init__`` imports as attributes (``from ku import io
    as io``)."""
    out = set(re.findall(r"^from ku import (\w+) as \1$", inspect.getsource(pkg), re.M))
    for n in dir(pkg):
        if not n.startswith("_") and not isinstance(getattr(pkg, n), types.ModuleType):
            out.add(n)
    return out


def _module_names(mod):
    """The public functions and classes a module defines, and its
    upper-case constants."""
    out = set()
    for n, v in vars(mod).items():
        if n.startswith("_"):
            continue
        if inspect.isfunction(v) or inspect.isclass(v):
            if v.__module__ == mod.__name__:
                out.add(n)
        elif n.isupper() and isinstance(v, (int, float, str)):
            out.add(n)
    return out


def _missing(name, names):
    port = importlib.import_module(_port_name(name))
    skip = NOT_PORTED.get(name, set())
    missing = sorted(n for n in names - skip if not hasattr(port, n))
    return missing, skip


@pytest.mark.parametrize("name", ["ku"] + PACKAGES)
def test_package_names_exist_in_the_port(name):
    missing, skip = _missing(name, _package_names(importlib.import_module(name)))
    assert not missing, f"{_port_name(name)} lacks {missing}"
    assert skip <= _package_names(importlib.import_module(name))  # the list stays honest


@pytest.mark.parametrize("name", [m for m in MODULES if NOT_PORTED.get(m, ()) is not None])
def test_module_names_exist_in_the_port(name):
    missing, skip = _missing(name, _module_names(importlib.import_module(name)))
    assert not missing, f"{_port_name(name)} lacks {missing}"
    assert skip <= _module_names(importlib.import_module(name))


def test_the_exceptions_are_still_missing():
    """Each listed exception is really absent from the port (so the list
    shrinks as they come), and every whole module it lists, and no other,
    is missing: with the list empty, every module of ku is in the port."""
    for name, names in NOT_PORTED.items():
        if names is None:
            assert importlib.util.find_spec(_port_name(name)) is None, name
            continue
        port = importlib.import_module(_port_name(name))
        assert not any(hasattr(port, n) for n in names), name
    unported = [m for m in MODULES if importlib.util.find_spec(_port_name(m)) is None]
    assert unported == sorted(m for m, names in NOT_PORTED.items() if names is None)


# -- the backend shim ---------------------------------------------------------------

MODES = ["CONSTANT", "REFLECT", "SYMMETRIC"]
SHAPES = {1: (5,), 2: (3, 4), 3: (2, 3, 4), 4: (2, 3, 2, 4)}


def _pairs(shape, seed, wide):
    rng = np.random.default_rng(seed)
    limit = [n - 1 if not wide else 2 * n + 1 for n in shape]
    return [(int(rng.integers(0, m + 1)), int(rng.integers(0, m + 1))) for m in limit]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rank", [1, 2, 3, 4])
def test_pad_matches_ku(mode, rank):
    x = np.random.default_rng(rank).standard_normal(SHAPES[rank]).astype(np.float32)
    for seed, wide in ((0, False), (1, False), (2, mode != "CONSTANT")):
        pairs = _pairs(x.shape, seed, wide)
        kw = {"constant_values": 1.5} if mode == "CONSTANT" else {}
        want = np.asarray(kb.pad(jnp.asarray(x), pairs, mode, **kw))
        got = pb.pad(torch.from_numpy(x), pairs, mode, **kw)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{mode} {pairs}")


def test_pad_lower_case_modes_and_numpy_input():
    x = np.arange(6.0).reshape(2, 3)
    for mode in ("constant", "reflect", "symmetric"):
        np.testing.assert_array_equal(pb.pad(x, [(1, 1), (2, 0)], mode).numpy(),
                                      np.asarray(kb.pad(jnp.asarray(x), [(1, 1), (2, 0)], mode)))
    with pytest.raises(ValueError):
        pb.pad(x, [(1, 1)], "reflect")


def test_where_transpose_broadcast_add_n():
    rng = np.random.default_rng(3)
    c = rng.random((3, 4, 2)) > 0.5
    x = rng.standard_normal((3, 4, 2)).astype(np.float32)
    y = rng.standard_normal((3, 4, 2)).astype(np.float32)
    got, want = pb.where(torch.from_numpy(c)), kb.where(jnp.asarray(c))
    assert isinstance(got, tuple) and len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(pb.where(c, x, y).numpy(), np.asarray(kb.where(c, x, y)))
    for perm in (None, (2, 0, 1)):
        np.testing.assert_array_equal(pb.transpose(x, perm).numpy(),
                                      np.asarray(kb.transpose(jnp.asarray(x), perm)))
    np.testing.assert_array_equal(pb.broadcast_to(x[:1], (5, 4, 2)).numpy(),
                                  np.asarray(kb.broadcast_to(x[:1], (5, 4, 2))))
    xs = [torch.from_numpy(rng.standard_normal(4)) for _ in range(3)]
    np.testing.assert_allclose(pb.add_n(xs).numpy(),
                               np.asarray(kb.add_n([jnp.asarray(t.numpy()) for t in xs])),
                               rtol=1e-6)


def test_cond_branches_like_ku():
    add, sub = (lambda a, b: a + b), (lambda a, b: a - b)
    for pred in (True, False, torch.tensor(True), torch.tensor(False)):
        want = kb.cond(bool(pred), add, sub, jnp.float32(5.0), jnp.float32(2.0))
        got = pb.cond(pred, add, sub, torch.tensor(5.0), torch.tensor(2.0))
        assert float(got) == float(want)


def test_multivariate_normal_diag_log_prob_matches_ku():
    rng = np.random.default_rng(4)
    loc = rng.standard_normal(6).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    x = rng.standard_normal((7, 6)).astype(np.float32)
    for s in (scale, None):
        want = kb.multivariate_normal_diag(loc, s).log_prob(jnp.asarray(x))
        got = pb.multivariate_normal_diag(torch.from_numpy(loc),
                                          None if s is None else torch.from_numpy(s)
                                          ).log_prob(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_multivariate_normal_diag_sample_moments():
    """Mean and std of 200k draws against loc and scale (5 standard errors),
    the shape ku's sample has, and the same draws from the same seed."""
    loc = torch.tensor([1.0, -2.0, 0.5])
    scale = torch.tensor([0.5, 2.0, 1.0])
    dist = pb.MultivariateNormalDiag(loc, scale)
    n = 200_000
    s = dist.sample(torch.Generator().manual_seed(0), (n,))
    ku_s = kb.MultivariateNormalDiag(jnp.asarray(loc.numpy()), jnp.asarray(scale.numpy())
                                     ).sample(jax.random.key(0), (4, 2))
    assert s.shape == (n, 3) and ku_s.shape == (4, 2, 3)
    assert dist.sample(None, (4, 2)).shape == (4, 2, 3)
    assert torch.all((s.mean(0) - loc).abs() < 5 * scale / n ** 0.5)
    assert torch.all((s.std(0) - scale).abs() < 5 * scale / (2 * n) ** 0.5)
    assert torch.equal(s[:5], dist.sample(torch.Generator().manual_seed(0), (n,))[:5])


def test_root_attributes_and_reexports():
    for name in ("applications_ext", "backend_ext", "layer_ext", "composite_layer",
                 "gnn_layer"):
        assert isinstance(getattr(ku_torch, name), types.ModuleType), name
    from ku_torch.composite_layer import DenseBatchNormalization
    from ku_torch.gnn_layer import GraphConvolutionNetwork
    from ku_torch.layer_ext import SIMILARITY_TYPE_ADDITIVE, MultiHeadAttention
    from ku_torch.nn import attention
    assert DenseBatchNormalization is ku_torch.nn.DenseBatchNormalization
    assert GraphConvolutionNetwork is ku_torch.nn.GraphConvolutionNetwork
    assert MultiHeadAttention is attention.MultiHeadAttention
    assert SIMILARITY_TYPE_ADDITIVE == ku.layer_ext.SIMILARITY_TYPE_ADDITIVE
