"""The plain version of ku_torch's CD kernel against ku, with forced draws.

Saturated biases (±200) and zero W make every Bernoulli draw certain
(sigmoid is exactly 0 or 1 in float32), so ku's Pallas kernel (interpret
mode), ku's lax.scan loop and the port must follow the same parameter
trajectory whatever their random numbers: this checks every product, mask,
bias, score and the carry across steps and epochs. The last batch is
ragged. Tolerances as in ku's own kernel tests: params rtol 1e-5 /
atol 1e-6, scores rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ku.ebm.rbm import cd_epoch_scan, cd_epoch_scan_pcd
from ku.pallas.cd_gibbs import cd_epoch_pallas, cd_train_pallas
from ku_torch.ebm import rbm as pt_rbm
from ku_torch.kernels.cd_gibbs import (
    MODE_VISIBLE_BERNOULLI,
    cd_train,
    cd_train_torch,
)
from ku_torch.utility import params_from_numpy, params_to_numpy

NAMES = ("rbm_weight", "hidden_bias", "visible_bias")


def saturated_params(v_dim=6, h_dim=4):
    return {
        "rbm_weight": np.zeros((v_dim, h_dim), np.float32),
        "hidden_bias": np.where(np.arange(h_dim) % 2 == 0, 200.0, -200.0
                                ).astype(np.float32),
        "visible_bias": np.where(np.arange(v_dim) % 3 == 0, 200.0, -200.0
                                 ).astype(np.float32),
    }


def ragged_batches(rng, batch, steps, v_dim, short):
    n = batch * steps - short
    data = rng.integers(0, 2, size=(batch * steps, v_dim)).astype(np.float32)
    data[n:] = 0.0
    mask = np.zeros((batch * steps,), np.float32)
    mask[:n] = 1.0
    return data, mask


def assert_params_close(got, want):
    got, want = params_to_numpy(got), params_to_numpy(want)
    for name in NAMES:
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def assert_scores_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("epochs", [1, 2])
@pytest.mark.parametrize("k", [1, 2])
def test_plain_cd_run_matches_ku_kernel_and_scan(rng, k, epochs):
    batch, steps = 16, 4
    p_np = saturated_params()
    data, mask = ragged_batches(rng, batch, steps, 6, short=5)
    p_pt, s_pt = cd_train_torch(params_from_numpy(p_np, "cpu"),
                                torch.from_numpy(data), torch.from_numpy(mask),
                                seed=7, lr=1e-3, k=k, mode=MODE_VISIBLE_BERNOULLI,
                                batch_size=batch, epochs=epochs)
    assert s_pt.shape == (epochs * steps,)

    p_j = {n: jnp.asarray(x) for n, x in p_np.items()}
    key = jax.random.key(11)
    if epochs == 1:
        p_pl, s_pl = cd_epoch_pallas(p_j, jnp.asarray(data), jnp.asarray(mask),
                                     key, 1e-3, k, MODE_VISIBLE_BERNOULLI, batch,
                                     interpret=True)
    else:
        p_pl, s_pl = cd_train_pallas(p_j, jnp.asarray(data), jnp.asarray(mask),
                                     key, 1e-3, k, MODE_VISIBLE_BERNOULLI, batch,
                                     epochs, interpret=True)
    assert_params_close(p_pt, p_pl)
    assert_scores_close(s_pt, s_pl)

    p_sc, s_sc = p_j, []
    for e in range(epochs):
        p_sc, s = cd_epoch_scan(p_sc, jnp.asarray(data), jnp.asarray(mask),
                                jax.random.fold_in(key, e), 1e-3, k,
                                MODE_VISIBLE_BERNOULLI, batch)
        s_sc.append(np.asarray(s))
    assert_params_close(p_pt, p_sc)
    assert_scores_close(s_pt, np.concatenate(s_sc))


@pytest.mark.parametrize("k", [1, 2])
def test_ported_scan_loop_matches_ku_scan(rng, k):
    batch = 8
    p_np = saturated_params()
    data, mask = ragged_batches(rng, batch, 3, 6, short=3)
    gen = torch.Generator().manual_seed(0)
    p_pt, s_pt = pt_rbm.cd_epoch_scan(params_from_numpy(p_np, "cpu"),
                                      torch.from_numpy(data), torch.from_numpy(mask),
                                      gen, 1e-3, k, MODE_VISIBLE_BERNOULLI, batch)
    p_ku, s_ku = cd_epoch_scan({n: jnp.asarray(x) for n, x in p_np.items()},
                               jnp.asarray(data), jnp.asarray(mask),
                               jax.random.key(3), 1e-3, k, MODE_VISIBLE_BERNOULLI,
                               batch)
    assert_params_close(p_pt, p_ku)
    assert_scores_close(s_pt, s_ku)


def test_ported_pcd_loop_matches_ku_pcd(rng):
    batch = 8
    p_np = saturated_params()
    data, mask = ragged_batches(rng, batch, 3, 6, short=3)
    chain = data[:batch].copy()
    gen = torch.Generator().manual_seed(0)
    p_pt, s_pt, c_pt = pt_rbm.cd_epoch_scan_pcd(
        params_from_numpy(p_np, "cpu"), torch.from_numpy(data),
        torch.from_numpy(mask), torch.from_numpy(chain), gen, 1e-3, 2,
        MODE_VISIBLE_BERNOULLI, batch)
    p_ku, s_ku, c_ku = cd_epoch_scan_pcd(
        {n: jnp.asarray(x) for n, x in p_np.items()}, jnp.asarray(data),
        jnp.asarray(mask), jnp.asarray(chain), jax.random.key(3), 1e-3, 2,
        MODE_VISIBLE_BERNOULLI, batch)
    assert_params_close(p_pt, p_ku)
    assert_scores_close(s_pt, s_ku)
    np.testing.assert_array_equal(c_pt.numpy(), np.asarray(c_ku))


def test_dispatch_runs_the_plain_version_for_cpu_tensors(rng):
    p = params_from_numpy(saturated_params(), "cpu")
    data, mask = ragged_batches(rng, 8, 2, 6, short=1)
    args = (p, torch.from_numpy(data), torch.from_numpy(mask), 5, 1e-3, 1,
            MODE_VISIBLE_BERNOULLI, 8, 1)
    p_a, s_a = cd_train(*args)
    p_b, s_b = cd_train_torch(*args)
    for name in NAMES:
        assert torch.equal(p_a[name], p_b[name])
    assert torch.equal(s_a, s_b)
