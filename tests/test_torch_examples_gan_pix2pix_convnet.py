"""The port's NobodyConvNet2D MNIST, GAN MNIST and pix2pix examples against
ku's, on the CPU.

- The classifier: ``Trainer(has_batch_stats=True).fit`` with AdamW from
  ku's initial variables, against ku's jitted ``Trainer`` with
  ``optax.adamw`` over the same rows and shuffles: each epoch's loss, the
  running statistics and ``predict`` within 1e-4 (of each tensor's largest
  entry), the parameters within 1e-4 plus Adam's per-entry allowance
  (``_hold_adam_params``, below: Module2's second BatchNorm scale, for one,
  has a gradient of 0 in exact arithmetic while the BatchNorm biases are
  0, the depthwise conv's BatchNorm after the ReLU making it
  scale-invariant), on
  the example's rows (the digits), over three steps: on this narrow net at
  batch 8 the two packages' rounding grows from step to step (25 times the
  allowance after six steps), whatever Adam's ε.
- gan_mnist and pix2pix: one ``train_multi_step`` call (S = 2 steps of one
  D and one G update) from ku's initial state, against ku's jitted
  ``_train_multi_step`` on the same batches. The first D loss, which reads
  the initial state, within 1e-5. Every later quantity reads parameters
  that Adam has moved, and Adam divides each entry's update by that
  entry's own RMS gradient: an entry whose gradient sits within rounding of
  0 (a ReLU unit live on one row, a pre-activation at a kink) moves by up
  to 2·lr in either package, and the next update's gradients carry it. So
  the later losses and Adam's moments are held within 1e-4 of each
  tensor's largest entry, and the parameters within 1e-4 plus the move
  that Adam's normalization gives a gradient known to 1e-4
  (``_hold_adam_params``). What one update computes is held apart, from
  ku's initial state: both losses and their gradients in every parameter
  within 1e-5 of each tensor's largest entry.
- Each example's ``main`` on the CPU at a reduced scale (few rows, steps
  and epochs), with its printed lines and the files it writes.
"""

import contextlib
import copy
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from examples_torch import common
from examples_torch.gan import gan_mnist as port_gan
from examples_torch.mnist_digit_classfication import nobody_convnet2d_mnist as port_cls
from examples_torch.pix2pix import pix2pix as port_p2p
from ku_torch.backprop import state_from_ku, state_to_ku
from ku_torch.utility import _flatten, load_variables, variables_from_module

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _import_ku(subdir, name):
    path = os.path.join(_REPO, "examples", subdir)
    sys.path.insert(0, path)
    try:
        return __import__(name)
    finally:
        sys.path.remove(path)


ku_cls = _import_ku("mnist_digit_classfication", "nobody_convnet2d_mnist")
ku_gan = _import_ku("gan", "gan_mnist")
ku_p2p = _import_ku("pix2pix", "pix2pix")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max(initial=0)), float(np.abs(want).max(initial=0))
    assert err <= rel * scale, f"{what}: max abs diff {err} > {rel} x {scale}"


def _close_tree(got, want, rel, what=""):
    g, w = _flatten(got), _flatten(want)
    assert g.keys() == w.keys(), (what, sorted(g), sorted(w))
    for k in w:
        _close(g[k], w[k], rel, f"{what}/{k}")


def _rows(n, seed=0):
    """n MNIST-like rows (the port's seeded stand-in), (n, 28, 28, 1) in
    [0, 255], and their labels."""
    V, gt = common.mnist_like(n, seed=seed)
    return V.reshape(-1, 28, 28, 1), gt


# -- the classifier ----------------------------------------------------------------------

CLS_ROWS, CLS_BATCH, CLS_EPOCHS = 24, 8, 1  # three steps
# The example's own rows on the CPU (sklearn's digits, smooth 28×28 images).
# On mnist_like's binary rows the BatchNorms of this narrow net at batch 8
# amplify rounding from step to step, so there the two packages' losses part
# by 1e-3 within six steps whatever the optimizer's ε.
DIGITS = common.load_mnist(flatten=False)


def test_classifier_fit_with_adamw_matches_ku():
    conf = port_cls.load_config(port_cls.CONF_PATH)
    hps = conf["hps"]
    V, gt = DIGITS[0][:CLS_ROWS], DIGITS[1][:CLS_ROWS]
    ku_model = ku_cls.ConvNetClassifier(conf=dict(conf))
    variables = jax.jit(ku_model.init)(jax.random.key(0), jnp.asarray(V[:1]))
    tx = optax.adamw(hps["lr"], b1=hps["beta_1"], b2=hps["beta_2"],
                     weight_decay=hps["weight_decay"])
    trainer = ku_cls.Trainer(
        ku_model,
        lambda y, p: ku_cls.categorical_crossentropy_with_label_gt(y, p, num_classes=10),
        optimizer=tx, has_batch_stats=True)
    trainer.state = {"params": variables["params"], "batch_stats": variables["batch_stats"],
                     "opt_state": tx.init(variables["params"]),
                     "step": jnp.zeros((), jnp.int32)}
    want_hist = trainer.fit(V, gt, batch_size=CLS_BATCH, epochs=CLS_EPOCHS, verbose=0)
    want_pred = trainer.predict(V)

    model = port_cls.ConvNetClassifier(conf, (CLS_BATCH, 28, 28, 1), device="cpu")
    assert [n for n, _ in model.named_children()] == ["NobodyConvNet2D_0", "Dense_0"]
    load_variables(model, _np(variables))
    port = port_cls.Trainer(model, port_cls.loss_fn, optimizer=port_cls.adamw(hps),
                            has_batch_stats=True)
    history = port.fit(V, gt, batch_size=CLS_BATCH, epochs=CLS_EPOCHS, verbose=0)
    np.testing.assert_allclose(history, want_hist, rtol=1e-4)
    got = variables_from_module(model)
    adam = next(st for st in trainer.state["opt_state"] if hasattr(st, "nu"))
    _hold_adam_params(got["params"], _np(trainer.state["params"]), _np(adam.nu),
                      int(adam.count), {"lr": hps["lr"], "beta_2": hps["beta_2"]}, 1e-4,
                      "params")
    _close_tree(got["batch_stats"], _np(trainer.state["batch_stats"]), 1e-4, "batch_stats")
    _close(port.predict(V), want_pred, 1e-4, "predict")


def test_classifier_main_writes_solution(tmp_path):
    V, gt = _rows(40, seed=1)
    out = port_cls.main("cpu", V.reshape(-1, 784), gt, epochs=0,
                        out_path=str(tmp_path / "solution.csv"), verbose=0)
    assert out["steps"] == 0 and out["history"] == []
    lines = (tmp_path / "solution.csv").read_text().splitlines()
    assert lines[0] == "ImageId,Label" and len(lines) == 41
    assert 0.0 <= out["accuracy"] <= 1.0


def test_classifier_main_trains_a_batch(tmp_path):
    V, gt = _rows(128, seed=2)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = port_cls.main("cpu", V, gt, epochs=1, out_path=str(tmp_path / "s.csv"))
    assert len(out["history"]) == 1 and np.isfinite(out["history"][0])
    assert "Training-set accuracy" in buf.getvalue()


# -- the GAN examples: one multi-step call against ku's ---------------------------------

GAN_B = 8
REL, LATER = 1e-5, 1e-4


def _ku_state(state):
    out = _np({k: v for k, v in state.items() if not k.endswith("_opt")})
    for side in ("gen_opt", "disc_opt"):
        adam = state[side][0]
        out[side] = _np({"count": adam.count, "mu": adam.mu, "nu": adam.nu})
    return out


def _stack(batches):
    return jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *batches)


def _hold_adam_params(got, want, nu, count, hps, rel, what):
    """Parameters after ``count`` Adam steps, entry by entry: within ``rel``
    of the tensor's largest entry, plus what the gradients' own tolerance
    can move Adam's updates by. A gradient is held to ``rel`` of its
    tensor's largest entry, but Adam divides each entry's update by that
    entry's RMS gradient √v̂, so an entry whose gradients are far below its
    tensor's largest moves with a relative error of rel·max√v̂ / (√v̂ + ε)
    a step (at most 2, a flipped sign): ``count·lr·min(2, that)``. A
    skipped update, or one of the wrong sign on a well-conditioned entry,
    misses by about lr."""
    lr, b2, eps = hps["lr"], hps["beta_2"], 1e-8
    g, w, v = _flatten(got), _flatten(want), _flatten(nu)
    assert g.keys() == w.keys() == v.keys(), what
    for k in w:
        got_k = g[k].detach().numpy() if isinstance(g[k], torch.Tensor) else g[k]
        rms = np.sqrt(v[k].astype(np.float64) / (1.0 - b2 ** count))
        allow = count * lr * np.minimum(2.0, rel * rms.max() / (rms + eps))
        tol = rel * np.abs(w[k]).max() + allow
        err = np.abs(got_k.astype(np.float64) - w[k])
        assert (err <= tol).all(), f"{what}/{k}: {float((err - tol).max())} over"


def _multi_step_against_ku(ku_example, port_example, data, gen, disc, steps=2):
    conf = copy.deepcopy(port_example.CONF)
    it = port_example.BatchIter(data, GAN_B, seed=3)
    k = int(conf["hps"]["disc_k_step"])
    groups = [[next(it) for _ in range(k + 1)] for _ in range(steps)]
    ku = ku_example.GAN(conf, gen, disc).compose_gan_with_mode().compile()
    ku.init_state(jax.tree.map(jnp.asarray, groups[0][0]), seed=0)
    before = _ku_state(ku.state)
    state, d_ku, g_ku = ku._train_multi_step(ku.state, _stack([_stack(b) for b in groups]), k,
                                             jax.random.key(5))
    after = _ku_state(state)

    engine = port_example.make_engine("cpu")
    engine.init_state()
    state_from_ku(engine, before)
    port_groups = [[{n: torch.from_numpy(np.asarray(v)) for n, v in b.items()} for b in gr]
                   for gr in groups]
    d, g = engine.train_multi_step(port_groups, k)
    # The first D loss reads the initial state; everything later reads
    # parameters that Adam has moved (see the module docstring).
    _close(d[0, 0], d_ku[0, 0], REL, "first D loss")
    _close(d, d_ku, LATER, "D losses")
    _close(g, g_ku, LATER, "G losses")
    got = state_to_ku(engine)
    assert int(got["step"]) == int(after["step"]) == steps
    hps = conf["hps"]["gen_disc_hps"]
    assert conf["hps"]["disc_ext_hps"] == hps
    for side in ("gen", "disc"):
        count = int(after[f"{side}_opt"]["count"])
        assert int(got[f"{side}_opt"]["count"]) == count == steps * (k if side == "disc" else 1)
        _hold_adam_params(got[f"{side}_params"], after[f"{side}_params"],
                          after[f"{side}_opt"]["nu"], count, hps, LATER, f"{side} params")
        for m in ("mu", "nu"):
            _close_tree(got[f"{side}_opt"][m], after[f"{side}_opt"][m], LATER, f"{side} {m}")


def _gradients_against_ku(ku_example, port_example, data, gen, disc):
    """Both losses and their gradients from ku's initial state, on one
    batch: the D loss in the discriminator's parameters, the G loss in the
    generator's."""
    conf = copy.deepcopy(port_example.CONF)
    batch = next(port_example.BatchIter(data, GAN_B, seed=11))
    ku = ku_example.GAN(conf, gen, disc).compose_gan_with_mode().compile()
    kb = jax.tree.map(jnp.asarray, batch)
    ku.init_state(kb, seed=0)
    key = jax.random.key(3)
    d_ku, dg_ku = jax.jit(jax.value_and_grad(ku._disc_loss))(ku.state["disc_params"],
                                                              ku.state, kb, key)
    (g_ku, _), gg_ku = jax.jit(jax.value_and_grad(ku._gen_loss, has_aux=True))(
        ku.state["gen_params"], ku.state, kb, jax.random.fold_in(key, 1))

    engine = port_example.make_engine("cpu")
    engine.init_state()
    state_from_ku(engine, _ku_state(ku.state))
    pb = {n: torch.from_numpy(np.asarray(v)) for n, v in batch.items()}
    draws = engine.state["gen"].generator
    for loss, want, grads_ku, module in (
            (engine._disc_loss(pb, draws), d_ku, dg_ku, engine.disc),
            (engine._gen_loss(pb, draws), g_ku, gg_ku, engine.gen)):
        _close(loss, want, REL, "loss")
        grads = torch.autograd.grad(loss, list(module.parameters()))
        names = [n.replace(".", "/") for n, _ in module.named_parameters()]
        _close_tree(dict(zip(names, grads)), _flatten(_np(grads_ku)), REL, "gradients")


def _gan_data():
    V, _ = common.mnist_like(64, seed=4)
    return (V / 127.5 - 1.0).astype(np.float32)


def _pix2pix_data():
    V, _ = _rows(64, seed=5)
    return (V / 127.5 - 1.0).astype(np.float32)


def test_gan_mnist_gradients_match_ku():
    _gradients_against_ku(ku_gan, port_gan, _gan_data(), ku_gan.Generator(),
                          ku_gan.Discriminator())


def test_pix2pix_gradients_match_ku():
    _gradients_against_ku(ku_p2p, port_p2p, _pix2pix_data(), ku_p2p.UNetGenerator(),
                          ku_p2p.PatchDisc())


def test_gan_mnist_multi_step_matches_ku():
    _multi_step_against_ku(ku_gan, port_gan, _gan_data(), ku_gan.Generator(),
                           ku_gan.Discriminator())


def test_pix2pix_multi_step_matches_ku():
    _multi_step_against_ku(ku_p2p, port_p2p, _pix2pix_data(), ku_p2p.UNetGenerator(),
                           ku_p2p.PatchDisc())


def test_port_batches_equal_kus():
    """The examples' batch iterators draw what ku's draw, in order."""
    V, _ = _rows(32, seed=6)
    X = (V / 127.5 - 1.0).astype(np.float32)
    for ku_it, port_it in ((ku_gan.BatchIter(X.reshape(-1, 784), 4, 1),
                            port_gan.BatchIter(X.reshape(-1, 784), 4, 1)),
                           (ku_p2p.BatchIter(X, 4, 1), port_p2p.BatchIter(X, 4, 1))):
        for _ in range(3):
            a, b = next(ku_it), next(port_it)
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])


def test_gan_mnist_main_reduced(tmp_path):
    conf = copy.deepcopy(port_gan.CONF)
    conf["hps"].update(epochs=2, batch_step=3, steps_per_call=2)
    V, _ = common.mnist_like(256, seed=7)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = port_gan.main("cpu", V, conf=conf, results_dir=str(tmp_path))
    assert len(out["history"]["disc_ext_loss"]) == 2
    assert -1.0 <= out["sample_min"] <= out["sample_max"] <= 1.0
    assert out["inter_sample_std"] > 0.0
    assert np.load(tmp_path / "gan_mnist_samples.npy").shape == (16, 784)
    assert "inter-sample std" in buf.getvalue()


def test_pix2pix_main_reduced(tmp_path):
    conf = copy.deepcopy(port_p2p.CONF)
    conf["hps"].update(epochs=1, batch_step=2)
    V, _ = _rows(128, seed=8)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = port_p2p.main("cpu", V, conf=conf, results_dir=str(tmp_path))
    assert np.isfinite(out["masked_l1"]) and out["blank_l1"] > 0.0
    assert np.load(tmp_path / "pix2pix_samples.npy").shape == (16, 28, 28, 1)
    assert "masked-region L1" in buf.getvalue()
