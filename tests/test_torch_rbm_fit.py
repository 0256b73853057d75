"""ku_torch's RBM and DBN end to end against ku, and weights across.

Both sides start from the same numpy parameters, saturated (biases ±200,
zero W) so that every draw is certain and the trajectories must agree
whatever the random numbers. The port trains on the CPU, by default through
its kernel's plain version; ku trains with its lax.scan backend. Data is
ragged. Tolerances as in ku's kernel tests: params rtol 1e-5 / atol 1e-6,
scores rtol 1e-4 / atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ku.ebm as ku_ebm
import ku.utility as ku_utility
import ku_torch.ebm as pt_ebm
import ku_torch.utility as pt_utility
from ku_torch.utility import params_from_numpy, params_to_numpy

from test_torch_cd_gibbs import assert_params_close, saturated_params

HPS = {"lr": 1e-3, "batch_size": 16, "epochs": 2}


def _pair(p_np, out_dim, in_dim, pt_hps=None, ku_hps=None):
    r_ku = ku_ebm.RBM({**HPS, "backend": "scan", **(ku_hps or {})}, out_dim,
                      input_dim=in_dim, seed=0)
    r_ku.params = {n: jnp.asarray(x) for n, x in p_np.items()}
    r_pt = pt_ebm.RBM({**HPS, **(pt_hps or {})}, out_dim, input_dim=in_dim,
                      seed=0, device="cpu")
    r_pt.params = params_from_numpy(p_np, "cpu")
    return r_ku, r_pt


@pytest.mark.parametrize("backend", [None, "scan"])
def test_rbm_fit_matches_ku(rng, backend):
    data = rng.integers(0, 2, size=(16 * 3 - 5, 6)).astype(np.float32)
    r_ku, r_pt = _pair(saturated_params(), 4, 6, pt_hps={"backend": backend})
    r_ku.fit(data, verbose=0)
    r_pt.fit(data, verbose=0)
    assert_params_close(r_pt.params, r_ku.params)
    # ku's scan backend keeps the last epoch's scores.
    np.testing.assert_allclose(r_pt.last_scores[-3:].numpy(),
                               np.asarray(r_ku.last_scores), rtol=1e-4, atol=1e-5)


def test_dbn_fit_and_transform_match_ku(rng):
    data = rng.integers(0, 2, size=(16 * 3 - 7, 6)).astype(np.float32)
    dbn_ku, dbn_pt = ku_ebm.DBN(), pt_ebm.DBN()
    for in_dim, out_dim in [(6, 4), (4, 3)]:
        r_ku, r_pt = _pair(saturated_params(in_dim, out_dim), out_dim, in_dim)
        dbn_ku.add_stack(r_ku)
        dbn_pt.add_stack(r_pt)
    dbn_ku.fit(data, verbose=0)
    dbn_pt.fit(data, verbose=0)
    for r_ku, r_pt in zip(dbn_ku.rbm_layers, dbn_pt.rbm_layers):
        assert_params_close(r_pt.params, r_ku.params)
    h_pt = dbn_pt.transform(data)
    np.testing.assert_array_equal(h_pt.numpy(), np.asarray(dbn_ku.transform(data)))
    assert h_pt.shape == (data.shape[0], 3)
    assert dbn_pt.inv_transform(h_pt).shape == data.shape


def _assert_equal_params(a, b):
    a, b = params_to_numpy(a), params_to_numpy(b)
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_array_equal(np.asarray(a[name]), np.asarray(b[name]))


@pytest.mark.parametrize("mode", [0, 2])
def test_ku_save_loads_in_port(tmp_path, mode):
    r_ku = ku_ebm.RBM(HPS, 4, input_dim=3, seed=1, mode=mode)
    r_ku.save(str(tmp_path / "rbm"))
    r_pt = pt_ebm.RBM.load(str(tmp_path / "rbm"), device="cpu")
    _assert_equal_params(r_pt.params, r_ku.params)
    assert (r_pt.mode, r_pt.input_dim, r_pt.output_dim) == (mode, 3, 4)


@pytest.mark.parametrize("mode", [0, 2])
def test_port_save_loads_in_ku(tmp_path, mode):
    r_pt = pt_ebm.RBM(HPS, 4, input_dim=3, seed=1, mode=mode, device="cpu")
    r_pt.save(str(tmp_path / "rbm"))
    r_ku = ku_ebm.RBM.load(str(tmp_path / "rbm"))
    _assert_equal_params(r_ku.params, r_pt.params)
    assert (r_ku.mode, r_ku.input_dim, r_ku.output_dim) == (mode, 3, 4)


def test_load_model_jh5_reads_the_same_arrays(tmp_path, rng):
    tree = {"enc": {"w": rng.normal(size=(3, 2)).astype(np.float32),
                    "b": np.arange(2, dtype=np.int32)},
            "scale": np.float32(2.5) * np.ones((4,), np.float32)}
    spec = {"kind": "test", "dims": [3, 2]}
    ku_utility.save_model_jh5(spec, {k: v for k, v in tree.items()},
                              str(tmp_path / "a"))
    pt_utility.save_model_jh5(spec, params_from_numpy(tree, "cpu"),
                              str(tmp_path / "b"))
    for name in ("a", "b"):
        spec_ku, p_ku = ku_utility.load_model_jh5(str(tmp_path / name))
        spec_pt, p_pt = pt_utility.load_model_jh5(str(tmp_path / name))
        assert spec_ku == spec_pt == spec
        for key in ("w", "b"):
            assert p_pt["enc"][key].dtype == tree["enc"][key].dtype
            np.testing.assert_array_equal(p_pt["enc"][key], np.asarray(p_ku["enc"][key]))
            np.testing.assert_array_equal(p_pt["enc"][key], tree["enc"][key])
        np.testing.assert_array_equal(p_pt["scale"], np.asarray(p_ku["scale"]))
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    np.testing.assert_array_equal(back["enc"]["w"], tree["enc"]["w"])
    assert isinstance(params_from_numpy(tree, "cpu")["enc"]["w"], torch.Tensor)
