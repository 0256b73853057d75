"""The plain version of ku_torch's CD kernel against ku's Pallas kernel in
interpret mode, with the interpreter's draws.

The Pallas interpreter's PRNG returns zero bits, so every uniform is 0:
each Bernoulli draw with p > 0 fires, and the Box-Muller normal is the
constant sqrt(−2 ln 1e−7) ≈ 5.678. Handing the port the same all-zero
uniforms replays ku's kernel exactly in the Gaussian and complex modes,
where W, the activations and the visible draws are all non-trivial. The
last batch is ragged. Tolerances as in ku's kernel tests: params rtol 1e-5 /
atol 1e-6, scores rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ku.pallas.cd_gibbs import cd_epoch_pallas
from ku_torch.kernels.cd_gibbs import (
    MODE_COMPLEX,
    MODE_VISIBLE_GAUSSIAN,
    cd_train_torch,
)
from ku_torch.utility import params_from_numpy, params_to_numpy


def zero_uniforms(step, n_streams, rows, cols):
    return torch.zeros(n_streams, rows, cols)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("mode", [MODE_VISIBLE_GAUSSIAN, MODE_COMPLEX])
def test_plain_cd_run_replays_interpret_kernel(rng, mode, k):
    v_dim, h_dim = 6, 4  # 3 complex units, stacked-real, in complex mode
    batch, steps = 8, 3
    p_np = {
        "rbm_weight": rng.normal(scale=0.1, size=(v_dim, h_dim)).astype(np.float32),
        "hidden_bias": rng.normal(scale=0.1, size=(h_dim,)).astype(np.float32),
        "visible_bias": rng.normal(scale=0.1, size=(v_dim,)).astype(np.float32),
    }
    n = batch * steps - 3
    data = rng.normal(size=(batch * steps, v_dim)).astype(np.float32)
    data[n:] = 0.0
    mask = np.zeros((batch * steps,), np.float32)
    mask[:n] = 1.0

    p_pt, s_pt = cd_train_torch(params_from_numpy(p_np, "cpu"),
                                torch.from_numpy(data), torch.from_numpy(mask),
                                seed=0, lr=1e-3, k=k, mode=mode, batch_size=batch,
                                epochs=1, uniforms=zero_uniforms)
    p_pl, s_pl = cd_epoch_pallas({n_: jnp.asarray(x) for n_, x in p_np.items()},
                                 jnp.asarray(data), jnp.asarray(mask),
                                 jax.random.key(5), 1e-3, k, mode, batch,
                                 interpret=True)
    p_pt = params_to_numpy(p_pt)
    for name in p_np:
        # The run moved the parameters, so the comparison is not vacuous.
        assert np.abs(p_pt[name] - p_np[name]).max() > 1e-4
        np.testing.assert_allclose(p_pt[name], np.asarray(p_pl[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(s_pt.numpy(), np.asarray(s_pl), rtol=1e-4, atol=1e-5)
