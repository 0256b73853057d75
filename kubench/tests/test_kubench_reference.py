"""The benchmark's plain reference against the port's own CPU paths, at a
tiny size: the port's plain CD run (``cd_train_torch``, which ``RBM.fit``
takes on the CPU) and ``DBN.fit``. The reference imports no part of the
port; this test may."""

import pytest
import torch

from kubench.harness import compare
from kubench.reference import cd as ref
from kubench.reference.philox import SeedStream, uniforms

PAIRS = (("rbm_weight", "W"), ("hidden_bias", "b_h"), ("visible_bias", "b_v"))


def rows(n, v, seed=5):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((n, v), generator=g) < 0.13).float()


@pytest.mark.parametrize("seed", [0, 4321, 2**32 - 1])
def test_philox_copy_draws_the_kernels_numbers(seed):
    from ku_torch.core.rng import philox_uniforms

    steps, streams = [0, 5, 17], [0, 1, 3]
    u = uniforms(seed, steps, streams, 7, 10)
    for i, t in enumerate(steps):
        w = philox_uniforms(seed, t, 4, 7, 10)
        for j, s in enumerate(streams):
            assert torch.equal(u[i, j], w[s])


def test_seed_stream_is_the_rbms():
    from ku_torch.core.rng import SeedSeq

    a, b = SeedStream(2**33 + 1), SeedSeq(2**33 + 1)
    assert [a.seed64(), a.seed32(), a.seed64()] == [b.seed64(), b.seed32(), b.seed64()]


@pytest.mark.parametrize("k,n,epochs", [(1, 300, 2), (2, 256, 1), (1, 37, 3)])
def test_rbm_fit_matches_the_ports_plain_run(k, n, epochs):
    from ku_torch.ebm import RBM

    V = rows(n, 40)
    hps = {"lr": 1e-3, "batch_size": 32, "epochs": epochs, "k": k}
    rbm = RBM(hps, 24, seed=2**31 + 7, device="cpu")
    rbm.fit(V, verbose=0)
    want = ref.rbm_fit(2**31 + 7, V, 24, 1e-3, k, 32, epochs)
    for p, r in PAIRS:
        torch.testing.assert_close(rbm.params[p], want.end[r], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(rbm.last_scores, want.scores, rtol=1e-6, atol=1e-6)


def test_dbn_fit_matches_the_ports_dbn():
    from ku_torch.ebm import DBN, RBM

    V = rows(300, 40)
    seeds, widths = (11, 12, 13), (30, 30, 50)
    dbn = DBN()
    for s, h in zip(seeds, widths):
        dbn.add_stack(RBM({"lr": 1e-3, "batch_size": 32, "epochs": 1}, h, seed=s, device="cpu"))
    dbn.fit(V, verbose=0)
    layers = ref.dbn_fit(seeds, V, widths, 1e-3, 1, 32, 1)
    # Each layer trains on the previous transform, so equal parameters and
    # scores in the later layers mean equal transforms too.
    for rbm, want in zip(dbn.rbm_layers, layers):
        for p, r in PAIRS:
            torch.testing.assert_close(rbm.params[p], want.end[r], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(rbm.last_scores, want.scores, rtol=1e-6, atol=1e-6)
    assert layers[-1].out.shape == (300, 50)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-12, 3.0e-3], dtype=torch.float32)
    y = ref._tf32_round(x)
    assert y[0] == x[0]
    assert y[1] == 1.0 + 2**-10
    assert abs(float(y[2] - x[2])) <= 2**-11 * float(x[2])


def test_first_scores_follow_a_draw_that_falls_the_other_way():
    """A run whose one draw near its threshold falls the other way, as
    rounding can make it in a sound program, is followed by
    ``first_scores``; without the near draws' paths it reads far off."""
    from ku_torch.core.rng import philox_uniforms
    from ku_torch.kernels.cd_gibbs import cd_train_torch

    V = rows(384, 100, seed=9)
    for root in range(200):  # a run whose nearest h+ draw of step 0 is within 5e-6
        seeds = SeedStream(root)
        start = ref.init_params(seeds.generator("cpu"), 100, 128)
        seed32 = seeds.seed32()
        u0 = uniforms(seed32, [0], [0], 128, 128)[0, 0]
        p0 = torch.sigmoid(V[:128] @ start["W"] + start["b_h"])
        if float((u0 - p0).abs().min()) < 5e-6:
            break
    r, c = divmod(int((u0 - p0).abs().argmin()), 128)

    def nudged(step, n_streams, n_rows, cols):
        u = philox_uniforms(seed32, step, n_streams, n_rows, cols)
        if step == 0:
            u[0, r, c] = 2 * p0[r, c] - u[0, r, c]  # mirrored across p: the draw flips
        return u

    params = {"rbm_weight": start["W"], "hidden_bias": start["b_h"],
              "visible_bias": start["b_v"]}
    mask = torch.ones(384)
    _, plain = cd_train_torch(params, V, mask, seed32, 1e-3, 1, 0, 128, 1)
    _, flipped = cd_train_torch(params, V, mask, seed32, 1e-3, 1, 0, 128, 1, uniforms=nudged)
    first = ref.first_scores(start, V, seed32, 1e-3, 1, 128, flipped[:3], near=1e-5)
    assert compare.loss_gap(flipped, first) < 1e-6
    straight = ref.first_scores(start, V, seed32, 1e-3, 1, 128, flipped[:3], near=0.0)
    torch.testing.assert_close(straight, plain[:3], rtol=1e-6, atol=0)
    assert compare.loss_gap(flipped, straight) > 1e-5
