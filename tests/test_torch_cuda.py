"""ku_torch's CD kernel on the card against its plain version.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernel is built
with nvcc at first use) and skip without one. They import nothing of JAX,
so on a machine without it run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes are deliberately ragged (widths that are not multiples of 32, more
batch rows than a warp, a short last batch) to exercise the kernel's
bounds checks. With saturated parameters every draw is certain, so kernel
and plain version must agree to rounding (rtol 1e-5 / atol 1e-6). With
random parameters both draw the same Philox numbers; float32 sums taken in
another order can still move a Bernoulli threshold by an ulp, which these
few steps at these sizes do not meet: params rtol 1e-5 / atol 1e-5, scores
rtol 1e-4 / atol 1e-4.
"""

import numpy as np
import pytest
import torch

from ku_torch.ebm import RBM
from ku_torch.kernels import cd_gibbs

pytestmark = pytest.mark.cuda
NAMES = ("rbm_weight", "hidden_bias", "visible_bias")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(device, v_dim, h_dim, batch, steps, mode, saturated, seed=0):
    rng = np.random.default_rng(seed)
    if saturated:
        w = np.zeros((v_dim, h_dim))
        bh = np.where(np.arange(h_dim) % 2 == 0, 200.0, -200.0)
        bv = np.where(np.arange(v_dim) % 3 == 0, 200.0, -200.0)
    else:
        w = rng.normal(scale=0.1, size=(v_dim, h_dim))
        bh = rng.normal(scale=0.1, size=h_dim)
        bv = rng.normal(scale=0.1, size=v_dim)
    n = batch * steps - batch // 3 - 1
    if mode == cd_gibbs.MODE_VISIBLE_BERNOULLI:
        data = (rng.random((batch * steps, v_dim)) < 0.3).astype(np.float32)
    else:
        data = rng.normal(size=(batch * steps, v_dim)).astype(np.float32)
    data[n:] = 0.0
    mask = (np.arange(batch * steps) < n).astype(np.float32)
    params = {name: torch.tensor(x, dtype=torch.float32, device=device)
              for name, x in zip(NAMES, (w, bh, bv))}
    return params, torch.from_numpy(data).to(device), torch.from_numpy(mask).to(device)


def _compare(device, v_dim, h_dim, batch, steps, epochs, k, mode, saturated,
             p_tol, s_tol):
    params, v_all, mask = _problem(device, v_dim, h_dim, batch, steps, mode,
                                   saturated)
    args = (params, v_all, mask, 1234, 1e-3, k, mode, batch, epochs)
    p_k, s_k = cd_gibbs.cd_train_cuda(*args)
    torch.cuda.synchronize()
    p_p, s_p = cd_gibbs.cd_train_torch(*args)
    for name in NAMES:
        torch.testing.assert_close(p_k[name], p_p[name], rtol=p_tol[0],
                                   atol=p_tol[1], msg=name)
    torch.testing.assert_close(s_k, s_p, rtol=s_tol[0], atol=s_tol[1])
    assert torch.isfinite(s_k).all()


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("shape", [(37, 45, 40, 3), (6, 4, 16, 4), (200, 70, 150, 2)])
def test_kernel_matches_plain_when_forced(device, shape, k):
    v_dim, h_dim, batch, steps = shape
    _compare(device, v_dim, h_dim, batch, steps, 2, k,
             cd_gibbs.MODE_VISIBLE_BERNOULLI, True, (1e-5, 1e-6), (1e-5, 1e-6))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_kernel_matches_plain_with_shared_draws(device, mode, k):
    _compare(device, 37, 45, 40, 3, 1, k, mode, False, (1e-5, 1e-5), (1e-4, 1e-4))


def test_kernel_rejects_what_it_does_not_take(device):
    params, v_all, mask = _problem(device, 8, 4, 4, 2, 0, True)
    with pytest.raises(ValueError, match="float32"):
        cd_gibbs.cd_train_cuda(params, v_all.double(), mask, 0, 1e-3, 1, 0, 4, 1)
    with pytest.raises(ValueError, match="multiple"):
        cd_gibbs.cd_train_cuda(params, v_all[:7], mask[:7], 0, 1e-3, 1, 0, 4, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cd_gibbs.cd_train_cuda(params, v_all.cpu(), mask, 0, 1e-3, 1, 0, 4, 1)


def test_rbm_fit_on_the_card_launches_the_kernel(device):
    rng = np.random.default_rng(1)
    data = (rng.random((300, 50)) < 0.2).astype(np.float32)
    before = cd_gibbs.cd_train_cuda.launches
    rbm = RBM({"lr": 1e-2, "batch_size": 32, "epochs": 3}, 16, seed=0)
    rbm.fit(data, verbose=0)
    torch.cuda.synchronize()
    assert cd_gibbs.cd_train_cuda.launches == before + 1
    assert rbm.last_scores.shape == (3 * 10,)
    assert torch.isfinite(rbm.last_scores).all()
    assert rbm.params["rbm_weight"].device.type == "cuda"
