"""The port's StyleGAN and autoencoder examples against ku's, on the CPU.

- ``TrainingSequenceFFHQ``'s synthetic batches from the same seed: z1, z2
  and the labels exactly, the images at 1e-6 (the 8×8 blobs resized by
  each package; at 4 px the resize shrinks them).
- ``fit_progressively`` over two tiny stages (4 and 8 px) against ku's,
  deterministic with the noise off as tests/test_torch_gan_stylegan.py
  runs the step: no style mixing, every noise weight 0 at each stage's
  start (each stage takes one step, so the noise weights' own update never
  reaches a forward pass), the learned constant and the moving mean drawn
  away from ku's degenerate ones. Each stage's modules start from ku's
  initial variables of that stage; the progressive loop itself carries the
  first stage's trained parameters into the second. The losses of each
  stage and the moving mean after it within 1e-4 of ku's (REL, as for one
  StyleGAN step).
- ``evaluate``'s per-class PNGs: readable, of the sample grid's size and
  pixels.
- The tuner's actor and critic after two updates with a fed action, from
  ku's parameters: within 1e-5 of ku's, the losses too.
- ``autoencoder_mnist``: the probe's accuracy within 0.05 of ku's example
  over sklearn's digits (ku's probe is sklearn's logistic regression, the
  port's the same objective by L-BFGS).
"""

import contextlib
import io
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples_torch.autoencoder import autoencoder_mnist
from examples_torch.style_based_gan import style_based_gan as port_example
from examples_torch.style_based_gan import style_based_gan_trainer as port_tuner
from ku_torch.image_utils import read_png
from ku_torch.utility import load_variables, variables_from_module

REL = 1e-4
CPU = "cpu"
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _import_ku(subdir, name):
    path = os.path.join(_REPO, "examples", subdir)
    sys.path.insert(0, path)
    try:
        return __import__(name)
    finally:
        sys.path.remove(path)


ku_example = _import_ku("style_based_gan", "style_based_gan")
ku_tuner = _import_ku("style_based_gan", "style_based_gan_trainer")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _conf(tmp_path):
    return {
        "mode": "train_progressively",
        "raw_data_path": str(tmp_path / "no_such_dir"),  # synthetic data
        "gan_mode": 2,
        "hps": {"epochs": 1, "batch_step": 1, "disc_k_step": 1, "batch_size": 4,
                "mixing_prob": None, "trunc_psi": 0.7, "trunc_cutoff": 2,
                "trunc_momentum": 0.99, "r_gamma": 10.0, "ch_base": 64, "max_ch": 16},
        "nn_arch": {"label_usage": True, "resolution": 8, "lane_packing": False,
                    "gen_prog_resolutions": [4, 8], "disc_prog_resolutions": [4, 8]},
        "map_nn_arch": {"latent_dim": 4, "dense1_dim": 8, "num_classes": 4,
                        "dlatent_dim": 8, "num_layers": 2},
        "disc_ext_hps": {"lr": 1e-3, "beta_1": 0.0, "beta_2": 0.99},
        "gen_disc_hps": {"lr": 1e-3, "beta_1": 0.0, "beta_2": 0.99},
    }


def _close(got, want, rel=REL, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel} x {scale:.3e}"


def _close_tree(got, want, rel, what=""):
    assert got.keys() == want.keys(), (what, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _close_tree(got[k], want[k], rel, f"{what}/{k}")
        else:
            _close(got[k], want[k], rel, f"{what}/{k}")


# -- the sequence ------------------------------------------------------------------


@pytest.mark.parametrize("resolution", [4, 8, 16])
def test_sequence_matches_ku(tmp_path, resolution):
    conf = _conf(tmp_path)
    nn_arch = dict(conf["nn_arch"], resolution=resolution)
    args = (conf["raw_data_path"], conf["hps"], nn_arch, conf["map_nn_arch"])
    ours, theirs = port_example.TrainingSequenceFFHQ(*args), ku_example.TrainingSequenceFFHQ(
        *args)
    for _ in range(2):
        got, want = next(ours), next(theirs)
        assert got.keys() == want.keys()
        for g, w in zip(got["z"], want["z"]):
            np.testing.assert_array_equal(g, np.asarray(w))
            assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(got["label"], want["label"])
        assert got["x"].shape == want["x"].shape == (4, resolution, resolution, 3)
        np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-6)


def test_sequence_reads_pngs(tmp_path):
    from ku_torch.image_utils import write_png

    rng = np.random.default_rng(0)
    for i in range(6):
        write_png(str(tmp_path / f"img_{i}.png"),
                  rng.integers(0, 256, size=(12, 12, 3), dtype=np.uint8))
    conf = _conf(tmp_path)
    seq = port_example.TrainingSequenceFFHQ(str(tmp_path), conf["hps"], conf["nn_arch"],
                                            conf["map_nn_arch"], batch_shuffle=False)
    batch = next(seq)
    assert batch["x"].shape == (4, 8, 8, 3)
    assert batch["x"].min() >= -1.0 and batch["x"].max() <= 1.0
    np.testing.assert_array_equal(batch["label"][:, 0], [0, 1, 2, 3])


# -- progressive training -----------------------------------------------------------


def _noise_off(params):
    return jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.zeros_like(v) if path[-1].key == "noise_weight" else v, params)


def _ku_progressive(tmp_path):
    """ku's two-stage run; each stage's initial variables (noise off, a drawn
    constant and moving mean), losses and moving mean after the stage."""
    inits, after = {}, {}

    class KuStyleGAN(ku_example.StyleGAN):
        def init_state(self, sample_batch, seed=0):
            """ku's ``AbstractGAN.init_state`` (the same keys and calls) with
            the modules' ``init`` jitted: eager flax compiles each op alone,
            eight seconds a stage here."""
            key = jax.random.key(seed)
            kg, kd = jax.random.split(key)
            gen_rngs = {"params": kg}
            for i, s in enumerate(self.gen_rng_streams):
                gen_rngs[s] = jax.random.fold_in(kg, i + 1)
            gen_vars = jax.jit(self.gen.init)(gen_rngs, sample_batch["z"])
            fake, _ = jax.jit(lambda v, z: self.gen.apply(v, z, rngs={
                s: jax.random.fold_in(kg, 99 + i) for i, s in enumerate(self.gen_rng_streams)},
                mutable=True))(gen_vars, sample_batch["z"])
            disc_vars = jax.jit(self.disc.init)(
                {"params": kd}, self._disc_input(sample_batch, self._gen_output_image(fake)))
            self.state = {
                "gen_params": gen_vars["params"], "gen_stats": gen_vars.get("batch_stats", {}),
                "disc_params": disc_vars["params"],
                "disc_stats": disc_vars.get("batch_stats", {}),
                "gen_opt": self.gen_opt.init(gen_vars["params"]),
                "disc_opt": self.disc_opt.init(disc_vars["params"]),
                "step": jnp.zeros((), jnp.int32)}
            res = self.gen.resolution
            state = dict(self.state)
            params = _noise_off(state["gen_params"])
            const = params["synthesis"]["const_input"]
            params["synthesis"]["const_input"] = jnp.asarray(
                np.random.default_rng(6 + res).normal(size=const.shape).astype(np.float32))
            state["gen_params"] = params
            mm = state["gen_stats"]["truncation"]["moving_mean"]
            state["gen_stats"] = {"truncation": {"moving_mean": jnp.asarray(
                np.random.default_rng(5 + res).normal(size=mm.shape).astype(np.float32))}}
            self.state = state
            inits[res] = jax.tree.map(np.asarray, {
                "gen": {"params": params, "batch_stats": state["gen_stats"]},
                "disc": {"params": state["disc_params"]}})
            return self

    class Recorder:
        def on_train_begin(self, engine):
            pass

        def on_epoch_end(self, engine, epoch, logs):
            after[epoch] = np.asarray(engine.state["gen_stats"]["truncation"]["moving_mean"])
            engine.state = dict(engine.state, gen_params=_noise_off(engine.state["gen_params"]))

        def on_train_end(self, engine, history):
            pass

    s_gan = KuStyleGAN(_conf(tmp_path))
    hist = s_gan.fit_progressively(sample_dir=str(tmp_path / "ku_results"),
                                   callbacks=[Recorder()])
    return inits, hist, after


def test_fit_progressively_matches_ku(tmp_path):
    inits, want_hist, want_after = _ku_progressive(tmp_path)
    after = {}

    class PortStyleGAN(port_example.StyleGAN):
        def _modules_at(self, resolution):
            gen, disc = super()._modules_at(resolution)
            load_variables(gen, inits[resolution]["gen"])
            load_variables(disc, inits[resolution]["disc"])
            return gen, disc

    def on_epoch_end(engine, epoch, logs):
        after[epoch] = engine.gen.truncation.moving_mean.detach().clone()
        with torch.no_grad():
            for name, p in engine.gen.named_parameters():
                if name.endswith("noise_weight"):
                    p.zero_()

    from ku_torch.utils import LambdaCallback

    s_gan = PortStyleGAN(_conf(tmp_path), device=CPU)
    hist = s_gan.fit_progressively(sample_dir=str(tmp_path / "results"),
                                   callbacks=[LambdaCallback(on_epoch_end=on_epoch_end)])
    assert len(hist) == len(want_hist) == 2
    for stage, (got, want) in enumerate(zip(hist, want_hist)):
        for key in ("disc_ext_loss", "gen_disc_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=REL, atol=0,
                                       err_msg=f"stage {stage} {key}")
        _close(after[stage], want_after[stage], what=f"stage {stage} moving mean")
    assert s_gan.gen.synthesis.resolution == 8
    assert os.path.exists(tmp_path / "results" / "progressive_final.png")


def test_evaluate_writes_per_class_pngs(tmp_path):
    conf = _conf(tmp_path)
    s_gan = port_example.StyleGAN(conf, device=CPU)
    s_gan.compile().init_state()
    out = tmp_path / "eval"
    s_gan.evaluate(result_dir=str(out), num_per_class=3, classes=(0, 2))
    for c in (0, 2):
        imgs = np.load(out / f"class_{c}.npy")
        assert imgs.shape == (3, 8, 8, 3) and np.isfinite(imgs).all()
        png = read_png(str(out / f"class_{c}.png"))
        grid = np.concatenate(list(np.clip(imgs, 0.0, 1.0)), axis=1)
        assert png.shape == grid.shape == (8, 24, 3)
        np.testing.assert_array_equal(png, np.rint(grid * 255).astype(np.uint8))
    # The same latents and labels as ku's generate_samples draws.
    a = s_gan.generate_samples(2, labels=np.array([[1], [3]]), seed=4)
    b = s_gan.generate_samples(2, labels=np.array([[1], [3]]), seed=4)
    np.testing.assert_array_equal(a, b)


# -- the tuner -------------------------------------------------------------------


def test_tuner_updates_match_ku():
    ranges = [ku_tuner.HPRange("lr", 1e-4, 1e-1, log=True), ku_tuner.HPRange("n", 2, 9,
                                                                             integer=True)]
    ku = ku_tuner.StyleGANTrainer(ranges, seed=0)
    port = port_tuner.StyleGANTrainer(
        [port_tuner.HPRange("lr", 1e-4, 1e-1, log=True), port_tuner.HPRange("n", 2, 9,
                                                                            integer=True)],
        seed=0, device=CPU)
    load_variables(port.actor, jax.tree.map(np.asarray, ku.actor_params))
    load_variables(port.critic, jax.tree.map(np.asarray, ku.critic_params))
    for action, reward in (([[0.3, -0.6]], 0.7), ([[-0.2, 0.9]], -0.4)):
        want = ku.update(jnp.asarray(action, jnp.float32), reward)
        got = port.update(torch.tensor(action), reward)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    _close_tree(variables_from_module(port.actor)["params"],
                jax.tree.map(np.asarray, ku.actor_params["params"]), 1e-5, "actor")
    _close_tree(variables_from_module(port.critic)["params"],
                jax.tree.map(np.asarray, ku.critic_params["params"]), 1e-5, "critic")
    assert [r.from_action(0.5) for r in port.hp_ranges] == [r.from_action(0.5) for r in ranges]
    hps, action = port.propose()
    assert action.shape == (1, 2) and float(action.abs().max()) <= 1.0
    assert 1e-4 * (1 - 1e-12) <= hps["lr"] <= 1e-1 * (1 + 1e-12) and isinstance(hps["n"], int)


# -- the autoencoder example --------------------------------------------------------------


def test_autoencoder_probe_within_005_of_ku():
    ku_ae = _import_ku("autoencoder", "autoencoder_mnist")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ku_ae.main()
    want = float(re.search(r"probe accuracy \(\d+ labels\): ([0-9.]+)", out.getvalue()).group(1))
    got = autoencoder_mnist.main(device=CPU, verbose=0)
    assert abs(got["probe_accuracy"] - want) <= 0.05, (got["probe_accuracy"], want)
    assert got["mse"] < 0.02 and got["epochs"] == 72 and got["n_labels"] == 449
