"""Data-parallel CD-k in ku_torch against ku, and across world sizes.

The port's data-parallel run (``ku_torch.kernels.cd_gibbs_dp``) takes each
step as a statistics pass over the rank's rows, an all-reduce, and an
update. Here its plain versions run

- with W ranks emulated in one process (the buffers summed in rank order)
  against ku's ring kernel (``cd_train_pallas_dp``, 8 devices, interpret
  mode), ku's single-device kernel and ku's ``cd_epoch_dp``, in saturation
  (biases ±200, so every draw is certain) or with the interpreter's constant
  draws fed to both; params rtol 1e-5 / atol 1e-6, scores rtol 1e-4 /
  atol 1e-5, ku's own tolerances;
- against the single-device plain run on random parameters: the ranks draw
  the single-device run's Philox numbers, so W = 1 is equal bit for bit and
  W = 2, 4 differ only by the order of the sums (1e-6);
- through ``RBM.fit(mesh=...)`` in a gloo world of one process and of two
  spawned processes.

ku's ring kernel takes about 20 s a call in interpret mode, and once
aborted a worker of a parallel run, so it is called in one test only.
"""

import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import ku_torch.dist as pt_dist
from ku.dist import make_mesh as ku_make_mesh
from ku.dist.mesh import cd_epoch_dp as ku_cd_epoch_dp
from ku.pallas.cd_gibbs import cd_train_pallas, cd_train_pallas_dp
from ku_torch.core.rng import philox_uniforms
from ku_torch.ebm import DBN, RBM
from ku_torch.kernels import cd_gibbs_dp
from ku_torch.kernels.cd_gibbs import (
    MODE_COMPLEX,
    MODE_VISIBLE_BERNOULLI,
    MODE_VISIBLE_GAUSSIAN,
    cd_train_torch,
)
from ku_torch.utility import params_from_numpy, params_to_numpy

from test_torch_cd_gibbs import (
    NAMES,
    assert_params_close,
    assert_scores_close,
    saturated_params,
)

BATCH, STEPS = 32, 3  # ku's ring-kernel test shapes: 4 rows a device on 8


def ku_params(p_np):
    return {n: jnp.asarray(x) for n, x in p_np.items()}


def ring_data(rng, v_dim=6, gaussian=False, short=3):
    """ku's ring-kernel test data: ragged tail inside the last shard."""
    rows = BATCH * STEPS
    if gaussian:
        data = rng.normal(size=(rows, v_dim)).astype(np.float32)
    else:
        data = rng.integers(0, 2, size=(rows, v_dim)).astype(np.float32)
    data[rows - short:] = 0.0
    mask = np.ones((rows,), np.float32)
    mask[rows - short:] = 0.0
    return data, mask


def random_params(rng, v_dim, h_dim, scale=0.1):
    return {"rbm_weight": rng.normal(scale=scale, size=(v_dim, h_dim)).astype(np.float32),
            "hidden_bias": rng.normal(scale=scale, size=h_dim).astype(np.float32),
            "visible_bias": rng.normal(scale=scale, size=v_dim).astype(np.float32)}


def interpreter_draws(step, n_streams, rows, cols):
    """ku's interpret-mode PRNG: every uniform is 0 (tests/
    test_cd_gibbs_kernel.py:275-279), whatever the seed."""
    return torch.zeros(n_streams, rows, cols)


def emulated(world, p_np, data, mask, epochs, mode=MODE_VISIBLE_BERNOULLI,
             k=1, uniforms=None, seed=7, lr=1e-3):
    return cd_gibbs_dp.cd_train_dp_emulated(
        world, params_from_numpy(p_np, "cpu"), torch.from_numpy(data),
        torch.from_numpy(mask), seed, lr, k, mode, BATCH, epochs, plain=True,
        uniforms=uniforms)


def test_plain_dp_matches_ku_ring_kernel(rng):
    """8 emulated ranks against ku's ring kernel on an 8-device mesh: in
    saturation over one epoch, and in complex mode over two epochs with the
    interpreter's draws."""
    mesh = ku_make_mesh({"data": 8})
    p_np = saturated_params()
    data, mask = ring_data(rng)
    p_ku, s_ku = cd_train_pallas_dp(
        mesh, ku_params(p_np), jnp.asarray(data), jnp.asarray(mask),
        jax.random.key(17), 1e-3, 1, MODE_VISIBLE_BERNOULLI, BATCH, 1,
        interpret=True)
    p_pt, s_pt = emulated(8, p_np, data, mask, 1)
    assert s_pt.shape == (STEPS,)
    assert_params_close(p_pt, p_ku)
    assert_scores_close(s_pt, s_ku)

    p_np = random_params(rng, 6, 4)
    data, mask = ring_data(rng, gaussian=True, short=5)
    p_ku, s_ku = cd_train_pallas_dp(
        mesh, ku_params(p_np), jnp.asarray(data), jnp.asarray(mask),
        jax.random.key(23), 1e-3, 1, MODE_COMPLEX, BATCH, 2, interpret=True)
    p_pt, s_pt = emulated(8, p_np, data, mask, 2, mode=MODE_COMPLEX,
                          uniforms=interpreter_draws)
    assert_params_close(p_pt, p_ku)
    assert_scores_close(s_pt, s_ku)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("epochs", [1, 2])
def test_plain_dp_matches_ku_single_device_kernel(rng, epochs, k):
    """8 emulated ranks against ku's single-device kernel on the same global
    batch, in saturation."""
    p_np = saturated_params()
    data, mask = ring_data(rng)
    p_ku, s_ku = cd_train_pallas(
        ku_params(p_np), jnp.asarray(data), jnp.asarray(mask),
        jax.random.key(3), 1e-3, k, MODE_VISIBLE_BERNOULLI, BATCH, epochs,
        interpret=True)
    p_pt, s_pt = emulated(8, p_np, data, mask, epochs, k=k)
    assert s_pt.shape == (epochs * STEPS,)
    assert_params_close(p_pt, p_ku)
    assert_scores_close(s_pt, s_ku)


@pytest.mark.parametrize("mode", [MODE_VISIBLE_BERNOULLI, MODE_VISIBLE_GAUSSIAN,
                                  MODE_COMPLEX])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_emulated_world_matches_single_device_run(rng, world, mode):
    """Random parameters, shared Philox draws: W = 1 equals the
    single-device plain run bit for bit; W = 2, 4 sum in another order."""
    p_np = random_params(rng, 16, 8)
    rows = BATCH * STEPS
    if mode == MODE_VISIBLE_BERNOULLI:
        data = (rng.random((rows, 16)) < 0.3).astype(np.float32)
    else:
        data = rng.normal(size=(rows, 16)).astype(np.float32)
    mask = (np.arange(rows) < rows - 6).astype(np.float32)
    data[rows - 6:] = 0.0
    p_dp, s_dp = emulated(world, p_np, data, mask, 1, mode=mode, lr=1e-2)
    p_1, s_1 = cd_train_torch(params_from_numpy(p_np, "cpu"),
                              torch.from_numpy(data), torch.from_numpy(mask),
                              7, 1e-2, 1, mode, BATCH, 1)
    if world == 1:
        for name in NAMES:
            assert torch.equal(p_dp[name], p_1[name]), name
        assert torch.equal(s_dp, s_1)
    else:
        for name in NAMES:
            torch.testing.assert_close(p_dp[name], p_1[name], rtol=1e-6,
                                       atol=1e-6, msg=name)
        torch.testing.assert_close(s_dp, s_1, rtol=1e-6, atol=1e-6)


def test_philox_row_offset_draws_the_matching_rows():
    full = philox_uniforms(99, 5, 4, 32, 13)
    for row0, rows in [(0, 8), (8, 8), (24, 8), (3, 17)]:
        part = philox_uniforms(99, 5, 4, rows, 13, row0=row0)
        assert torch.equal(part, full[:, row0:row0 + rows])


@pytest.fixture
def world_of_one():
    """A gloo world of one process, destroyed after the test."""
    assert not dist.is_initialized()
    mesh = pt_dist.make_mesh(devices="cpu")
    yield mesh
    dist.destroy_process_group()


def test_value_errors(rng):
    p_np = saturated_params()
    data, mask = ring_data(rng)
    with pytest.raises(ValueError, match="does not divide"):
        emulated(3, p_np, data, mask, 1)
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 1"):
        pt_dist.make_mesh({"data": 2}, devices="cpu")
    assert not dist.is_initialized()


def test_world_of_one_fit_equals_single_device_fit(rng, world_of_one):
    """RBM.fit(mesh=) in a gloo world of one process: the data-parallel run
    equals the single-device fit bit for bit; backend "scan" runs the
    port's cd_epoch_dp, which agrees with ku's in saturation."""
    data = (rng.random((BATCH * STEPS - 5, 6)) < 0.3).astype(np.float32)
    hps = {"lr": 1e-2, "batch_size": BATCH, "epochs": 2}
    runs = cd_gibbs_dp.cd_train_dp.runs
    r_dp = RBM(hps, 4, seed=3, device="cpu").fit(data, verbose=0, mesh=world_of_one)
    r_1 = RBM(hps, 4, seed=3, device="cpu").fit(data, verbose=0)
    assert cd_gibbs_dp.cd_train_dp.runs == runs + 1
    for name in NAMES:
        assert torch.equal(r_dp.params[name], r_1.params[name]), name
    assert torch.equal(r_dp.last_scores, r_1.last_scores)
    assert r_dp.last_scores.shape == (2 * STEPS,)

    p_np = saturated_params()
    r_scan = RBM({**hps, "backend": "scan"}, 4, input_dim=6, seed=0, device="cpu")
    r_scan.params = params_from_numpy(p_np, "cpu")
    r_scan.fit(data, verbose=0, mesh=world_of_one)
    assert cd_gibbs_dp.cd_train_dp.runs == runs + 1
    p_ku = ku_params(p_np)
    v_all, m_all = np.zeros((BATCH * STEPS, 6), np.float32), np.zeros(BATCH * STEPS, np.float32)
    v_all[:len(data)], m_all[:len(data)] = data, 1.0
    for e in range(2):
        p_ku, s_ku = ku_cd_epoch_dp(ku_make_mesh({"data": 1}), p_ku, jnp.asarray(v_all),
                                    jnp.asarray(m_all), jax.random.key(e), 1e-2, 1,
                                    MODE_VISIBLE_BERNOULLI, BATCH)
    assert_params_close(r_scan.params, p_ku)
    assert_scores_close(r_scan.last_scores, s_ku)


def _rank_main(rank, store_path, out_path, data, p_sat, p_rand):
    """One rank of the two-process test: fits through the mesh, writes what
    it learned to ``out_path``."""
    torch.set_num_threads(1)  # tiny shapes; spare the other test workers
    pt_dist.initialize_multihost(backend="gloo", rank=rank, world_size=2,
                                 store=dist.FileStore(store_path, 2))
    mesh = pt_dist.make_mesh()
    hps = {"lr": 1e-2, "batch_size": BATCH, "epochs": 2}
    out = {}
    r = RBM(hps, 4, input_dim=6, seed=5, device="cpu")
    r.params = params_from_numpy(p_rand, "cpu")
    r.fit(data, verbose=0, mesh=mesh)
    out.update({f"dp_{n}": x for n, x in params_to_numpy(r.params).items()})
    out["dp_scores"] = r.last_scores.numpy()

    r = RBM({**hps, "backend": "scan"}, 4, input_dim=6, seed=5, device="cpu")
    r.params = params_from_numpy(p_sat, "cpu")
    r.fit(data, verbose=0, mesh=mesh)
    out.update({f"scan_{n}": x for n, x in params_to_numpy(r.params).items()})
    out["scan_scores"] = r.last_scores.numpy()

    dbn = DBN()
    dbn.add_stack(RBM({**hps, "epochs": 1}, 4, seed=1, device="cpu"))
    dbn.add_stack(RBM({**hps, "epochs": 1}, 3, seed=2, device="cpu"))
    for layer in dbn.rbm_layers:
        layer.build(6 if layer is dbn.rbm_layers[0] else 4)
    init = [params_to_numpy(layer.params) for layer in dbn.rbm_layers]
    dbn.fit(data, verbose=0, mesh=mesh)
    for i, layer in enumerate(dbn.rbm_layers):
        for n, x in params_to_numpy(layer.params).items():
            out[f"dbn{i}_{n}"] = x
            out[f"dbn{i}_init_{n}"] = init[i][n]
    out["dbn_h"] = dbn.transform(data).numpy()

    try:
        pt_dist.cd_epoch_dp(mesh, r.params, torch.zeros(33, 6), torch.ones(33),
                            torch.Generator().manual_seed(0), 1e-2, 1, 0, 33)
        out["odd_batch_raised"] = np.array(False)
    except ValueError:
        out["odd_batch_raised"] = np.array(True)
    dist.destroy_process_group()
    np.savez(out_path, **out)


def test_two_process_gloo_fit(rng, tmp_path):
    """Two spawned ranks over gloo: the same params on both, equal to the
    emulated W = 2 run; backend "scan" against ku's cd_epoch_dp on a
    2-device mesh; DBN.fit(mesh=) trains both layers."""
    data = (rng.random((BATCH * STEPS - 5, 6)) < 0.3).astype(np.float32)
    p_sat, p_rand = saturated_params(), random_params(rng, 6, 4)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp_path / "store"), str(tmp_path / f"rank{r}.npz"),
                               data, p_sat, p_rand))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(120)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    assert not alive, "a rank did not finish within 120 s"
    assert [p.exitcode for p in procs] == [0, 0]
    out = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for key in out[0]:
        np.testing.assert_array_equal(out[0][key], out[1][key], err_msg=key)

    # The kernel route, against two ranks emulated with the RBM's seed.
    seed = RBM({}, 4, input_dim=6, seed=5, device="cpu")._seeds.seed32()
    v_all = np.zeros((BATCH * STEPS, 6), np.float32)
    m_all = np.zeros(BATCH * STEPS, np.float32)
    v_all[:len(data)], m_all[:len(data)] = data, 1.0
    p_em, s_em = emulated(2, p_rand, v_all, m_all, 2, seed=seed, lr=1e-2)
    for name in NAMES:
        np.testing.assert_array_equal(out[0][f"dp_{name}"], p_em[name].numpy(),
                                      err_msg=name)
    np.testing.assert_array_equal(out[0]["dp_scores"], s_em.numpy())

    p_ku = ku_params(p_sat)
    for e in range(2):
        p_ku, s_ku = ku_cd_epoch_dp(ku_make_mesh({"data": 2}), p_ku, jnp.asarray(v_all),
                                    jnp.asarray(m_all), jax.random.key(e), 1e-2, 1,
                                    MODE_VISIBLE_BERNOULLI, BATCH)
    assert_params_close({n: out[0][f"scan_{n}"] for n in NAMES}, p_ku)
    assert_scores_close(out[0]["scan_scores"], s_ku)

    for i in range(2):
        for n in NAMES:
            assert np.isfinite(out[0][f"dbn{i}_{n}"]).all()
        assert not np.array_equal(out[0][f"dbn{i}_rbm_weight"],
                                  out[0][f"dbn{i}_init_rbm_weight"]), i
    assert out[0]["dbn_h"].shape == (len(data), 3)
    assert out[0]["odd_batch_raised"]
