"""ku_torch's RBM functions, seed streams and package rules, held against ku.

Inputs come from numpy and cross into each package as arrays; the port
runs on the CPU. Tolerances: rtol 1e-6 / atol 1e-6, float32 on both sides
with the same formulas (only the order of summation may differ).
"""

import ast
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ku.core.config as ku_config
import ku.core.rng as ku_rng
import ku.ebm.rbm as ku_rbm
import ku_torch.core.config as pt_config
import ku_torch.ebm.rbm as pt_rbm
from ku_torch.core.rng import SeedSeq, philox4x32, philox_uniforms, uniform_from_bits
from ku_torch.kernels import cd_gibbs
from ku_torch.utility import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
MODES = [pt_rbm.MODE_VISIBLE_BERNOULLI, pt_rbm.MODE_VISIBLE_GAUSSIAN,
         pt_rbm.MODE_COMPLEX]


def _params(rng, v_dim, h_dim):
    return {
        "rbm_weight": rng.normal(scale=0.3, size=(v_dim, h_dim)).astype(np.float32),
        "hidden_bias": rng.normal(scale=0.3, size=(h_dim,)).astype(np.float32),
        "visible_bias": rng.normal(scale=0.3, size=(v_dim,)).astype(np.float32),
    }


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_pure_functions_match_ku(rng, mode):
    v_dim, h_dim = 10, 6  # 5 complex units, stacked-real, in complex mode
    p_np = _params(rng, v_dim, h_dim)
    v = rng.normal(size=(7, v_dim)).astype(np.float32)
    if mode == pt_rbm.MODE_VISIBLE_BERNOULLI:
        v = (v > 0).astype(np.float32)
    h = (rng.random((7, h_dim)) < 0.5).astype(np.float32)
    p_j = {k: jnp.asarray(x) for k, x in p_np.items()}
    p_t = params_from_numpy(p_np, "cpu")
    v_t, h_t = torch.from_numpy(v), torch.from_numpy(h)
    _close(pt_rbm.hidden_prob(p_t, v_t, mode), ku_rbm.hidden_prob(p_j, v, mode))
    _close(pt_rbm.neg_hidden_prob(p_t, v_t, mode),
           ku_rbm.neg_hidden_prob(p_j, v, mode))
    _close(pt_rbm.visible_stat(p_t, h_t), ku_rbm.visible_stat(p_j, h))
    _close(pt_rbm.free_energy(p_t, v_t, mode), ku_rbm.free_energy(p_j, v, mode))


@pytest.mark.parametrize("mode", MODES[:2])
def test_rbm_layer_matches_ku(rng, mode):
    p_np = _params(rng, 5, 3)
    v = rng.normal(size=(4, 5)).astype(np.float32)
    layer_ku = ku_rbm.RBMLayer.as_flax(3, mode=mode)
    want = layer_ku.apply({"params": {"rbm_weight": p_np["rbm_weight"],
                                      "hidden_bias": p_np["hidden_bias"]}}, v)
    layer_pt = pt_rbm.RBMLayer(5, 3, mode=mode, device="cpu")
    with torch.no_grad():
        layer_pt.rbm_weight.copy_(torch.from_numpy(p_np["rbm_weight"]))
        layer_pt.hidden_bias.copy_(torch.from_numpy(p_np["hidden_bias"]))
    got = layer_pt(torch.from_numpy(v))
    _close(got.detach(), want)
    assert not layer_pt.rbm_weight.requires_grad


def test_rbm_layer_defaults_to_the_card():
    """Like every module of the port, RBMLayer is made on "cuda" unless the
    caller asks for the CPU; a generator on another device is refused by
    name, before anything is drawn or moved."""
    assert inspect.signature(pt_rbm.RBMLayer).parameters["device"].default == "cuda"
    cpu_gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="generator on cpu"):
        pt_rbm.RBMLayer(5, 3, generator=cpu_gen)
    layer = pt_rbm.RBMLayer(5, 3, generator=cpu_gen, device="cpu")
    assert layer.rbm_weight.device.type == "cpu"


def test_complex_stacking_matches_ku(rng):
    z = (rng.normal(size=(4, 5)) + 1j * rng.normal(size=(4, 5))).astype(np.complex64)
    stacked_ku = np.asarray(ku_rbm.complex_to_stacked(z))
    stacked_pt = pt_rbm.complex_to_stacked(z)
    np.testing.assert_array_equal(stacked_pt.numpy(), stacked_ku)
    np.testing.assert_array_equal(
        pt_rbm.complex_to_stacked(torch.from_numpy(z)).numpy(), stacked_ku)
    np.testing.assert_array_equal(pt_rbm.stacked_to_complex(stacked_pt).numpy(),
                                  ku_rbm.stacked_to_complex(stacked_ku))


def _philox_numpy(c, k0, k1):
    """Philox4x32-10 in numpy uint64: the 64-bit products are exact."""
    c0, c1, c2, c3 = (np.asarray(x, np.uint64) for x in c)
    mask = np.uint64(0xFFFFFFFF)
    k0, k1 = np.uint64(k0), np.uint64(k1)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & mask
            k1 = (k1 + np.uint64(0xBB67AE85)) & mask
        p0 = np.uint64(0xD2511F53) * c0
        p1 = np.uint64(0xCD9E8D57) * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & mask,
                          (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & mask)
    return c0, c1, c2, c3


def test_philox_matches_numpy_bit_for_bit(rng):
    # Known-answer vectors of Philox4x32-10 (Random123).
    kat = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD))]
    for c, k, want in kat:
        got_t = philox4x32(*(torch.tensor([x]) for x in c), *k)
        got_n = _philox_numpy([[x] for x in c], *k)
        assert [int(x[0]) for x in got_t] == list(want)
        assert [int(x[0]) for x in got_n] == list(want)
    c = rng.integers(0, 2**32, size=(4, 4096), dtype=np.uint64)
    for k0, k1 in [(0, 0), (123456789, 7), (2**32 - 1, 2**31 + 5)]:
        got = philox4x32(*(torch.from_numpy(x.astype(np.int64)) for x in c), k0, k1)
        want = _philox_numpy(c, k0, k1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy().astype(np.uint64), w)


def test_philox_uniforms_follow_the_kernel_layout():
    seed, step, streams, rows, cols = 99, 13, 4, 5, 11
    u = philox_uniforms(seed, step, streams, rows, cols)
    s, r, c = np.meshgrid(np.arange(streams), np.arange(rows), np.arange(cols),
                          indexing="ij")
    words = _philox_numpy([c // 4, r, s, np.zeros_like(c)], seed, step)
    bits = np.choose(c % 4, [w.astype(np.int64) for w in words])
    np.testing.assert_array_equal(u.numpy(), (bits >> 8).astype(np.float32) / 2**24)
    bits_np = np.arange(0, 2**32, 2**20 + 12345, dtype=np.uint32)
    np.testing.assert_array_equal(
        uniform_from_bits(torch.from_numpy(bits_np.astype(np.int64))).numpy(),
        np.asarray(ku_rng.uniform_from_bits(jnp.asarray(bits_np))))


def test_seed_seq_is_reproducible():
    a, b = SeedSeq(5), SeedSeq(5)
    assert [a.seed32() for _ in range(3)] == [b.seed32() for _ in range(3)]
    ga, gb = a.generator(), b.generator()
    assert torch.equal(torch.rand(8, generator=ga), torch.rand(8, generator=gb))
    assert SeedSeq(6).seed32() != SeedSeq(5).seed32()


def test_config_copy_matches_ku(tmp_path):
    path = tmp_path / "conf.json"
    path.write_text('{"mode": 0, "hps": {"lr": 0.001, "batch_size": 128}}')
    c_pt = pt_config.load_config(str(path), ["hps.lr", "hps.batch_size"])
    c_ku = ku_config.load_config(str(path), ["hps.lr", "hps.batch_size"])
    assert c_pt == c_ku and c_pt.hps.lr == 0.001
    for mod in (pt_config, ku_config):
        with pytest.raises(KeyError):
            mod.load_config(str(path), ["hps.epochs"])


_BANNED = {"jax", "jaxlib", "flax", "optax", "ku"}


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_ku():
    files = sorted((ROOT / "ku_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 5
    for f in files:
        roots = set(_imported_roots(ast.parse(f.read_text(), str(f))))
        assert not roots & _BANNED, f"{f.relative_to(ROOT)} imports {roots & _BANNED}"


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt_rbm.RBM({"lr": 1e-3, "batch_size": 4, "epochs": 1}, 3)


@pytest.mark.parametrize("backend", ["cuda", "pallas"])
def test_kernel_backend_on_cpu_raises_and_trains_nothing(rng, backend):
    rbm = pt_rbm.RBM({"lr": 1e-3, "batch_size": 4, "epochs": 1, "backend": backend},
                     3, input_dim=5, device="cpu")
    before = {k: v.clone() for k, v in rbm.params.items()}
    with pytest.raises(ValueError, match="CUDA kernel"):
        rbm.fit(rng.random((8, 5)).astype(np.float32), verbose=0)
    for k, v in rbm.params.items():
        assert torch.equal(v, before[k])


def test_kernel_wrapper_refuses_cpu_tensors():
    params = params_from_numpy(_params(np.random.default_rng(1), 5, 3), "cpu")
    launches = cd_gibbs.cd_train_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        cd_gibbs.cd_train_cuda(params, torch.zeros(8, 5), torch.ones(8), 0, 1e-3,
                               1, 0, 4, 1)
    assert cd_gibbs.cd_train_cuda.launches == launches


def test_mesh_is_not_ported():
    # fit(mesh=) is ported (tests/test_torch_cd_gibbs_dp.py); what this
    # checks now is that a mesh that is not a DeviceMesh is refused before
    # any training.
    rbm = pt_rbm.RBM({"lr": 1e-3, "batch_size": 4, "epochs": 1}, 3, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        rbm.fit(np.zeros((8, 5), np.float32), mesh=object())
    assert rbm.last_scores is None
