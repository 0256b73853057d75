"""The port's sharding helpers (``ku_torch.dist``) against ``ku.dist`` on the
CPU.

``ku`` places each leaf with ``jax.device_put(leaf, NamedSharding(mesh,
P(...)))`` on its 8-device CPU mesh; the port decides each placement in
plain functions of (the mesh's axis sizes, the leaf's '/'-joined path, its
shape), which these tests hold against ``leaf.sharding.spec`` of ``ku``'s
placed leaves, exactly, on the meshes ``ku``'s own tests use: {"data": 4,
"model": 2}, {"model": 4} and {"data": 2, "model": 3}. A torch
``DeviceMesh`` of eight ranks cannot be built in one process; the placement
itself (``DTensor`` leaves, this rank's slice) is checked on a gloo world of
one process here and of two in ``tests/test_torch_multiprocess.py``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import ku
from ku.dist import make_mesh as ku_make_mesh
from ku.dist import shard_decode_state as ku_shard_decode_state
from ku.dist import shard_gan_state as ku_shard_gan_state
from ku.dist import shard_stacked_batches as ku_shard_stacked
from ku.models import StyleGANDiscriminator as KuDisc
from ku.models import StyleGANGenerator as KuGen
import ku_torch.dist as pd
from ku_torch.dist.mesh import (
    decode_cache_spec,
    decode_heads_divide,
    decode_param_spec,
    gan_leaf_spec,
)
from ku_torch.nn import Transformer

MESHES = [{"data": 4, "model": 2}, {"model": 4}, {"data": 2, "model": 3}]
GEN = dict(resolution=4, ch_base=32, max_ch=12, latent_dim=6, dlatent_dim=24,
           dense1_dim=24, num_mapping_layers=3, num_classes=0, label_usage=False,
           mixing_prob=None)
DISC = dict(resolution=4, ch_base=32, max_ch=12, label_usage=False)


def _path(path) -> str:
    """A jax key path as ku's helpers join it."""
    return "/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path)


def _spec(leaf) -> tuple:
    return tuple(leaf.sharding.spec)


@pytest.fixture(scope="module")
def ku_gan_state():
    gen, disc = KuGen(**GEN), KuDisc(**DISC)
    z = jnp.zeros((4, 6), jnp.float32)
    gv = jax.jit(lambda k: gen.init({"params": k}, (z, z)))(jax.random.key(0))
    dv = jax.jit(disc.init)(jax.random.key(1), jnp.zeros((4, 4, 4, 3), jnp.float32))
    opt = optax.adam(1e-3, b1=0.0, b2=0.99)
    return {"gen_params": gv["params"], "gen_stats": gv["batch_stats"],
            "disc_params": dv["params"], "disc_stats": {},
            "gen_opt": opt.init(gv["params"]), "disc_opt": opt.init(dv["params"]),
            "step": jnp.zeros((), jnp.int32)}


@pytest.mark.parametrize("axes", MESHES, ids=str)
def test_gan_state_placement_matches_ku(ku_gan_state, axes):
    placed = ku_shard_gan_state(ku_gan_state, ku_make_mesh(axes))
    split = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
        want = _spec(leaf)
        assert gan_leaf_spec(_path(path), leaf.shape, axes) == want, _path(path)
        split += bool(want)
    # map_dense_*, style_dense_* and dense_1 kernels (params and both Adam
    # moments) split where their columns divide; the rest replicated.
    assert split >= 9


def _decode_case(axes, h, hkv, dm, **kw):
    """ku's Transformer block, its params, a prefill's cache and the placed
    pair; the port's block of the same conf and its own prefill's cache."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 4, dm)).astype(np.float32)
    block = ku.Transformer(h, dm, 0.0, causal=True, num_kv_head=hkv, max_decode_len=8, **kw)
    variables = jax.jit(block.init)(jax.random.key(0), [jnp.asarray(x)])
    _, cache = jax.jit(lambda v, t: block.apply(v, [t], decode=True, mutable=["cache"]))(
        variables, jnp.asarray(x))
    port = Transformer(h, dm, 0.0, causal=True, num_kv_head=hkv, max_decode_len=8,
                       device="cpu", **kw)
    with torch.no_grad():
        _, port_cache = port([torch.from_numpy(x)], decode=True, cache={})
    return variables["params"], cache["cache"], port, port_cache


DECODE_CASES = [
    # (mesh, h, hkv, d_model, data_axis, block kwargs)
    ({"model": 4}, 8, 4, 32, None, dict(kv_cache_dtype="int8")),
    ({"data": 4, "model": 2}, 4, 2, 16, "data", {}),
    ({"data": 4, "model": 2}, 4, 2, 16, "data", dict(kv_page_size=4, kv_num_pages=9)),
    ({"data": 2, "model": 3}, 6, 3, 12, "data", dict(kv_cache_dtype="int8")),
    # Heads that do not divide the model axis: the fallback.
    ({"model": 4}, 2, 2, 32, None, {}),
    ({"data": 2, "model": 3}, 2, 2, 12, "data", dict(kv_page_size=4, kv_num_pages=5)),
]


@pytest.mark.parametrize("axes,h,hkv,dm,data_axis,kw", DECODE_CASES,
                         ids=lambda c: str(c) if isinstance(c, dict) else None)
def test_decode_state_placement_matches_ku(axes, h, hkv, dm, data_axis, kw):
    params, cache, port, port_cache = _decode_case(axes, h, hkv, dm, **kw)
    tp = axes["model"]
    heads = decode_heads_divide(tp, h, hkv)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ku_params, ku_cache = ku_shard_decode_state(
            params, cache, ku_make_mesh(axes), num_head=h, num_kv_head=hkv,
            data_axis=data_axis)
    assert heads == (tp in (2, 4) and h == 2 * hkv or (h, hkv) == (6, 3))
    assert any("replicated" in str(w.message) for w in caught) == (not heads)
    want_params = {_path(p): _spec(leaf)
                   for p, leaf in jax.tree_util.tree_leaves_with_path(ku_params)}
    # The port's own parameter names and shapes give ku's placement.
    got_params = {name.replace(".", "/"): (decode_param_spec(name.replace(".", "/"),
                                                             tuple(t.shape), tp)
                                           if heads else ())
                  for name, t in port.state_dict().items()}
    assert got_params == want_params
    want_cache = {_path(p): _spec(leaf)
                  for p, leaf in jax.tree_util.tree_leaves_with_path(ku_cache)}
    got_cache = {key: decode_cache_spec(key.rsplit("/", 1)[-1], tuple(t.shape), tp,
                                        data_axis=data_axis, heads=heads)
                 for key, t in port_cache.items()}
    assert got_cache == want_cache
    if heads:
        assert any("model" in s for s in want_cache.values())


def test_stacked_batches_and_data_parallel_specs():
    """ku's stacked-batch and data-parallel shardings: the spec the port
    builds for each (a mesh of one process stands for ku's 8 devices)."""
    mesh = ku_make_mesh({"data": 4, "model": 2})
    batches = {"x": jnp.zeros((2, 8, 3)), "z": jnp.zeros((3, 2, 8, 5))}
    for axis in (1, 2):
        leaf = ku_shard_stacked({"x": batches["x"] if axis == 1 else batches["z"]}, mesh,
                                batch_axis=axis)["x"]
        assert _spec(leaf) == (None,) * axis + ("data",)
    assert tuple(ku.dist.data_parallel_sharding(mesh, 3, 1).spec) == (None, "data", None)
    assert tuple(ku.dist.replicate(mesh).spec) == ()


@pytest.fixture
def world_of_one():
    assert not dist.is_initialized()
    mesh = pd.make_mesh({"data": 1, "model": 1}, devices="cpu")
    yield mesh
    dist.destroy_process_group()


def test_placement_on_a_world_of_one(world_of_one):
    """The port's placed leaves: DTensors over the mesh whose local slice is
    the whole leaf at size 1, the specs as placements per mesh dimension."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = world_of_one
    s = pd.data_parallel_sharding(mesh, 3, axis=1)
    assert s.spec == (None, "data", None)
    assert s.placements == [Shard(1), Replicate()]
    assert pd.NamedSharding(mesh, (None, "model")).placements == [Replicate(), Shard(1)]
    assert pd.replicate(mesh).placements == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="does not fit"):
        pd.NamedSharding(mesh, ("seq",))
    x = torch.arange(24.0).reshape(2, 3, 4)
    placed = pd.place(x, s)
    assert isinstance(placed, DTensor) and torch.equal(placed.to_local(), x)
    assert torch.equal(pd.local_slice(x, s), x)

    state = {"gen_params": {"map": {"map_dense_0": {"kernel": np.ones((4, 6), np.float32)}}},
             "step": 3}
    out = pd.shard_gan_state(state, mesh)
    kernel = out["gen_params"]["map"]["map_dense_0"]["kernel"]
    assert kernel.placements == (Replicate(), Shard(1)) and out["step"] == 3
    stacked = pd.shard_stacked_batches({"x": torch.zeros(2, 4, 3)}, mesh)
    assert stacked["x"].placements == (Shard(1), Replicate())
    params, cache = pd.shard_decode_state(
        {"b.MultiHeadAttention_0.W_Q": torch.zeros(8, 8)},
        {"b/MultiHeadAttention_0/cached_key": torch.zeros(2, 2, 4, 8)}, mesh,
        num_head=2, data_axis="data")
    assert params["b.MultiHeadAttention_0.W_Q"].placements == (Replicate(), Shard(1))
    assert cache["b/MultiHeadAttention_0/cached_key"].placements == (Shard(0), Shard(1))
