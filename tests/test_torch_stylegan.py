"""ku_torch's StyleGAN models against ku's, on the CPU.

ku's variables (params and batch_stats) go through
``state_dict_from_tree(..., batch_stats=...)`` into the port's modules with
``strict=True``; the same numpy-made inputs go through both, ku's under
``jax.jit``. Tolerance: 1e-4 of the largest entry of ku's output (f32
through every layer of the net). ku's side runs with ``lane_packing``
False and True (``lane_pack_min`` 8); the port computes the unpacked
function for both.

Noise and style mixing cannot draw JAX's numbers, so the training-mode
comparison runs with ``mixing_prob=None`` and every noise weight 0 (the
truncation's moving mean still moves), and the port's own draws are
checked by distribution. The 16-px conf is ku's test conf
(tests/test_stylegan.py); the narrow 128-px conf reaches the fused
transposed conv (maps of 128 px) and the fused stride-2 conv (maps of 64
px and more); ``__graft_entry__.entry``'s full conf is ``slow``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ku.models import (
    MappingNetwork as KuMapping,
    StyleGANDiscriminator as KuDisc,
    StyleGANGenerator as KuGen,
    cal_num_chs as ku_cal_num_chs,
)
from ku_torch.models import (
    MappingNetwork,
    StyleGANDiscriminator,
    StyleGANGenerator,
    cal_num_chs,
)
from ku_torch.models.stylegan import _ApplyNoise
from ku_torch.utility import state_dict_from_tree, variables_from_module

REL = 1e-4
CPU = "cpu"
TEST_CONF = dict(resolution=16, ch_base=64, max_ch=32, latent_dim=16, dlatent_dim=32,
                 dense1_dim=32, num_mapping_layers=3, num_classes=10, label_usage=True,
                 mixing_prob=0.9, trunc_psi=0.7, trunc_cutoff=4)
NARROW_128 = dict(TEST_CONF, resolution=128, ch_base=512, max_ch=32)
ENTRY_CONF = dict(resolution=128, ch_base=1024, max_ch=512, latent_dim=64, dlatent_dim=64,
                  dense1_dim=64, num_mapping_layers=8, num_classes=1000, label_usage=True,
                  mixing_prob=None, trunc_psi=0.7, trunc_cutoff=8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one torch thread is faster here and spares the other
    test workers the oversubscribed cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rel=REL):
    got = got.detach().float().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, f"max abs diff {err} > {rel} x {scale}"


def _gen_inputs(conf, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    z1 = rng.normal(size=(batch, conf["latent_dim"])).astype(np.float32)
    z2 = rng.normal(size=(batch, conf["latent_dim"])).astype(np.float32)
    label = rng.integers(0, conf["num_classes"], size=(batch, 1))
    return z1, label, z2


def _ku_gen_variables(conf, inputs, **kw):
    gen = KuGen(**conf, **kw)
    rngs = {"params": jax.random.key(0), "noise": jax.random.key(1),
            "style": jax.random.key(2)}
    variables = jax.jit(gen.init)(rngs, tuple(map(jnp.asarray, inputs)))
    # A moving mean away from zero, so that the truncation does something.
    mm = variables["batch_stats"]["truncation"]["moving_mean"]
    stats = {"truncation": {"moving_mean": jnp.asarray(
        np.random.default_rng(5).normal(size=mm.shape).astype(np.float32))}}
    return {"params": variables["params"], "batch_stats": stats}


def _port(cls, conf, variables, **kw):
    module = cls(**conf, device=CPU, **kw)
    module.load_state_dict(state_dict_from_tree(
        variables["params"], CPU, batch_stats=variables.get("batch_stats")), strict=True)
    return module


def _ku_gen_out(conf, variables, inputs, **kw):
    gen = KuGen(**conf, **kw)
    return np.asarray(jax.jit(lambda v, i: gen.apply(v, i, deterministic=True))(
        variables, tuple(map(jnp.asarray, inputs))))


def _t_inputs(inputs):
    return tuple(torch.from_numpy(np.asarray(a)) for a in inputs)


@pytest.mark.parametrize("i,base,top", [(0, 1024, 512), (2, 1024, 512), (6, 1024, 512),
                                        (3, 64, 32), (6, 64, 8)])
def test_cal_num_chs(i, base, top):
    assert cal_num_chs(i, base, top) == ku_cal_num_chs(i, base, top)


@pytest.mark.parametrize("label_usage", [True, False])
def test_mapping_network(label_usage):
    kw = dict(latent_dim=16, dlatent_dim=32, dense1_dim=24, num_mapping_layers=3,
              num_broadcast_layers=6, num_classes=10, label_usage=label_usage)
    rng = np.random.default_rng(0)
    z = rng.normal(size=(3, 16)).astype(np.float32)
    label = rng.integers(0, 10, size=(3, 1))
    ku_map = KuMapping(**kw)
    args = (jnp.asarray(z), jnp.asarray(label)) if label_usage else (jnp.asarray(z),)
    params = jax.jit(ku_map.init)(jax.random.key(0), *args)
    want = jax.jit(ku_map.apply)(params, *args)
    port = _port(MappingNetwork, kw, params)
    got = port(torch.from_numpy(z), torch.from_numpy(label) if label_usage else None)
    _close(got, want, rel=1e-5)


# ku's packed 128-px path is held in the slow entry-conf test.
CASES = [("test", False), ("test", True), ("narrow 128", False)]


@pytest.mark.parametrize("conf,lane_packing", CASES)
def test_generator_matches_ku(conf, lane_packing):
    conf = TEST_CONF if conf == "test" else NARROW_128
    kw = dict(lane_packing=lane_packing, lane_pack_min=8)
    inputs = _gen_inputs(conf)
    variables = _ku_gen_variables(conf, inputs)
    want = _ku_gen_out(conf, variables, inputs, **kw)
    port = _port(StyleGANGenerator, conf, variables, **kw)
    _close(port(_t_inputs(inputs), deterministic=True), want)


def _disc_case(conf, lane_packing, dtype=None, batch=4, seed=0):
    res = conf["resolution"]
    kw = dict(resolution=res, ch_base=conf["ch_base"], max_ch=conf["max_ch"])
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, res, res, 3)).astype(np.float32)
    label = rng.integers(0, 10, size=(batch, 1)).astype(np.float32)
    disc = KuDisc(**kw, lane_packing=lane_packing, lane_pack_min=8)
    params = jax.jit(disc.init)(jax.random.key(0), (jnp.asarray(x), jnp.asarray(label)))
    want = jax.jit(disc.apply)(params, (jnp.asarray(x), jnp.asarray(label)))
    port = _port(StyleGANDiscriminator, kw, params, lane_packing=lane_packing,
                 lane_pack_min=8, dtype=dtype)
    return port, x, label, want


@pytest.mark.parametrize("conf,lane_packing", CASES)
def test_discriminator_matches_ku(conf, lane_packing):
    port, x, label, want = _disc_case(TEST_CONF if conf == "test" else NARROW_128,
                                      lane_packing)
    _close(port((torch.from_numpy(x), torch.from_numpy(label))), want)


def test_generator_training_mode_matches_ku():
    """No mixing and every noise weight 0: the output and the updated
    moving mean equal ku's; the output is pulled toward the updated mean."""
    conf = dict(TEST_CONF, mixing_prob=None)
    inputs = _gen_inputs(conf, batch=3)
    variables = _ku_gen_variables(conf, inputs)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.zeros_like(v) if path[-1].key == "noise_weight" else v,
        variables["params"])
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    gen = KuGen(**conf)
    want, mutated = jax.jit(lambda v, i, r: gen.apply(
        v, i, deterministic=False, rngs={"noise": r, "style": r},
        mutable=["batch_stats"]))(variables, tuple(map(jnp.asarray, inputs)),
                                  jax.random.key(7))
    port = _port(StyleGANGenerator, conf, variables)
    got = port(_t_inputs(inputs), deterministic=False,
               generator=torch.Generator().manual_seed(0))
    _close(got, want)
    _close(port.truncation.moving_mean,
           mutated["batch_stats"]["truncation"]["moving_mean"], rel=1e-6)
    assert not np.allclose(port.truncation.moving_mean.numpy(),
                           np.asarray(variables["batch_stats"]["truncation"]["moving_mean"]))


def test_generator_own_draws():
    """With noise and mixing on: noise fields are N(0, 1), one per layer
    shared by the batch, drawn from the generator passed in (same seed,
    same image); the moving mean moves."""
    noise = _ApplyNoise(64, device=CPU)
    x = torch.zeros(3, 16, 16, 64)
    with torch.no_grad():
        n = noise(x, generator=torch.Generator().manual_seed(0))
    assert torch.equal(n[0], n[2])
    assert abs(float(n.mean())) < 0.02 and abs(float(n.std()) - 1.0) < 0.02
    conf = TEST_CONF
    gen = StyleGANGenerator(**conf, device=CPU, generator=torch.Generator().manual_seed(0))
    inputs = _t_inputs(_gen_inputs(conf))
    start = gen.truncation.moving_mean.clone()
    outs = []
    for seed in (1, 1, 2):
        gen.truncation.moving_mean.copy_(start)
        with torch.no_grad():
            outs.append(gen(inputs, generator=torch.Generator().manual_seed(seed)))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert bool(torch.isfinite(outs[0]).all()) and float(outs[0].abs().max()) <= 1.0
    assert float(gen.truncation.moving_mean.abs().sum()) > 0


def test_batch_stats_round_trip():
    """ku's params and batch_stats → strict load → back, bit for bit."""
    inputs = _gen_inputs(TEST_CONF)
    variables = _ku_gen_variables(TEST_CONF, inputs)
    port = _port(StyleGANGenerator, TEST_CONF, variables)
    assert "truncation.moving_mean" in dict(port.named_buffers())
    back = variables_from_module(port)
    for coll in ("params", "batch_stats"):
        want = {"/".join(str(p.key) for p in path): np.asarray(v) for path, v in
                jax.tree_util.tree_flatten_with_path(variables[coll])[0]}
        got = {"/".join(str(p.key) for p in path): v for path, v in
               jax.tree_util.tree_flatten_with_path(back[coll])[0]}
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_bf16_generator_matches_f32():
    """bf16 compute, f32 params and output, within ku's own 4e-2."""
    inputs = _gen_inputs(TEST_CONF)
    variables = _ku_gen_variables(TEST_CONF, inputs)
    want = _ku_gen_out(TEST_CONF, variables, inputs)
    port = _port(StyleGANGenerator, TEST_CONF, variables, dtype=torch.bfloat16)
    with torch.no_grad():
        got = port(_t_inputs(inputs), deterministic=True)
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in port.parameters())
    np.testing.assert_allclose(got.numpy(), want, atol=4e-2)


def test_bf16_discriminator_logit_is_f32():
    port, x, label, want = _disc_case(TEST_CONF, False, dtype=torch.bfloat16)
    with torch.no_grad():
        got = port((torch.from_numpy(x), torch.from_numpy(label)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=5e-2, atol=5e-2 * float(np.abs(want).max()))


@pytest.mark.slow
def test_entry_conf_generator_matches_ku():
    """__graft_entry__.entry's conf (128 px, ch_base 1024, lane packing),
    batch 4."""
    inputs = _gen_inputs(ENTRY_CONF, batch=4)
    variables = _ku_gen_variables(ENTRY_CONF, inputs)
    want = _ku_gen_out(ENTRY_CONF, variables, inputs, lane_packing=True)
    port = _port(StyleGANGenerator, ENTRY_CONF, variables, lane_packing=True)
    with torch.no_grad():
        _close(port(_t_inputs(inputs), deterministic=True), want)
