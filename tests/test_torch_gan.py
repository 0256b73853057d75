"""ku_torch's GAN engine against ku's, on the CPU, with toy MLPs.

The toy generator and discriminator mirror tests/test_gan.py's flax ones
under the same parameter names, so ku's state (params, optax's Adam
moments, the step) carries across through ``state_from_ku`` and comes back
through ``state_to_ku``. The toy modules draw nothing, so in every mode but
WGAN-GP the step is the same function in both packages; WGAN-GP's ε is
drawn by ku's key (``fold_in(fold_in(key, i), 7)``) and handed to the port.

Tolerance: 1e-5 of each tensor's largest entry (REL), for the losses, the
gradients, the parameters and Adam's moments after a step. Both packages
compute in f32 with the same formulas; only the order of sums differs.
Adam with β1 = 0 moves every entry by lr·g/(|g| + 1e-8) on its first step:
an entry whose gradient sits within rounding of 0 could move by up to 2·lr
between the packages, which REL would not forgive. No such entry occurs on
these inputs (the toy's dead ReLU units have gradients of exactly 0 in both
packages), so the parameters are held at REL too.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ku.backprop import GAN as KuGAN
from ku.backprop import get_loss_conf as ku_get_loss_conf
from ku.backprop.gan import _merge_shared as ku_merge_shared
from ku_torch.backprop import (
    GAN,
    LSGAN,
    PIX2PIX_GAN,
    STYLE_GAN_REGULAR,
    STYLE_GAN_SOFTPLUS_INVERSE_R1_GP,
    STYLE_GAN_WGAN_GP,
    compose_gan_with_mode,
    get_loss_conf,
    state_from_ku,
    state_to_ku,
)
from ku_torch.backprop.gan import _merge_shared
from ku_torch.core import TrainState
from ku_torch.engine_ext import adam
from ku_torch.nn.transformer import Dense
from ku_torch.utility import _flatten

REL = 1e-5
CPU = "cpu"
MODES = [STYLE_GAN_REGULAR, STYLE_GAN_WGAN_GP, STYLE_GAN_SOFTPLUS_INVERSE_R1_GP, LSGAN,
         PIX2PIX_GAN]
K = 2
HPS = {
    "epochs": 1, "batch_step": 1, "disc_k_step": K, "r_gamma": 10.0,
    "wgan_lambda": 10.0, "wgan_target": 1.0,
    "disc_ext_hps": {"lr": 1e-3, "beta_1": 0.0, "beta_2": 0.99},
    "gen_disc_hps": {"lr": 1e-3, "beta_1": 0.0, "beta_2": 0.99},
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one torch thread is faster here and spares the other
    test workers the oversubscribed cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the toy models (tests/test_gan.py:22-37), in both packages ----------------


class KuToyGen(fnn.Module):
    out_dim: int = 8

    @fnn.compact
    def __call__(self, z, deterministic: bool = True):
        h = fnn.relu(fnn.Dense(16)(z))
        return fnn.Dense(self.out_dim)(h)


class KuToyDisc(fnn.Module):
    @fnn.compact
    def __call__(self, x, deterministic: bool = True):
        if isinstance(x, (tuple, list)):
            x = jnp.concatenate(list(x), axis=-1)
        h = fnn.relu(fnn.Dense(16)(x))
        return fnn.Dense(1)(h)


class ToyGen(torch.nn.Module):
    def __init__(self, z_dim=4, out_dim=8, hidden=16, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.Dense_0 = Dense(z_dim, hidden, device=CPU, generator=g)
        self.Dense_1 = Dense(hidden, out_dim, device=CPU, generator=g)

    def forward(self, z, deterministic: bool = True):
        return self.Dense_1(torch.relu(self.Dense_0(z)))


class ToyDisc(torch.nn.Module):
    def __init__(self, in_dim=8, hidden=16, seed=1):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.Dense_0 = Dense(in_dim, hidden, device=CPU, generator=g)
        self.Dense_1 = Dense(hidden, 1, device=CPU, generator=g)

    def forward(self, x, deterministic: bool = True):
        if isinstance(x, (tuple, list)):
            x = torch.cat(list(x), dim=-1)
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def _data_iter(rng, mode, n_dim=8, batch=16):
    while True:
        x = rng.normal(loc=2.0, scale=0.5, size=(batch, n_dim)).astype(np.float32)
        z = rng.normal(size=(batch, 4)).astype(np.float32)
        batch_d = {"x": x, "z": z}
        if mode == PIX2PIX_GAN:
            batch_d["cond"] = rng.normal(size=(batch, 2)).astype(np.float32)
        yield batch_d


def _port(mode, **hps):
    conf = {"hps": dict(HPS, composing_mode=mode, **hps)}
    disc = ToyDisc(in_dim=10 if mode == PIX2PIX_GAN else 8)
    return GAN(conf, ToyGen(), disc).compose_gan_with_mode().compile()


def _ku(mode, **hps):
    conf = {"hps": dict(HPS, composing_mode=mode, **hps)}
    return KuGAN(conf, KuToyGen(), KuToyDisc()).compose_gan_with_mode().compile()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _stack(batches):
    return jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *batches)


def _ku_state(state):
    """ku's state as numpy, each optax Adam state as {"count", "mu", "nu"}."""
    out = _np({k: v for k, v in state.items() if not k.endswith("_opt")})
    for side in ("gen_opt", "disc_opt"):
        adam_state = state[side][0]
        out[side] = _np({"count": adam_state.count, "mu": adam_state.mu,
                         "nu": adam_state.nu})
    return out


def _close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max(initial=0)), float(np.abs(want).max(initial=0))
    assert err <= rel * scale, f"{what}: max abs diff {err} > {rel} x {scale}"
    return err / scale if scale else 0.0


def _close_tree(got, want, rel=REL, what=""):
    """Each leaf within rel of its largest entry; returns the worst ratio."""
    g, w = _flatten(got), _flatten(want)
    assert g.keys() == w.keys(), (what, sorted(g), sorted(w))
    return max((_close(g[k], w[k], rel, f"{what}/{k}") for k in w), default=0.0)


def _port_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _eps(key, i, batch):
    return np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.fold_in(key, i), 7),
                                         (batch["x"].shape[0], 1)))


def _feed_eps(engine, eps):
    it = iter(eps)
    engine._interp_eps = lambda x_real, generator: torch.from_numpy(np.array(next(it)))


@functools.lru_cache(maxsize=None)
def _ku_run(mode, steps=1, seed=0, **hps):
    """ku's jitted step(s) from its init: the batches, the state before, each
    step's losses and state after, and WGAN-GP's ε for each D step."""
    rng = np.random.default_rng(seed)
    it = _data_iter(rng, mode)
    engine = _ku(mode, **hps)
    groups = [[next(it) for _ in range(K + 1)] for _ in range(steps)]
    engine.init_state(jax.tree.map(jnp.asarray, groups[0][0]), seed=seed)
    state = engine.state
    before = _ku_state(state)
    runs = []
    for s, batches in enumerate(groups):
        key = jax.random.key(100 + s)
        eps = [_eps(key, i, batches[i]) for i in range(K)]
        state = jax.tree.map(jnp.copy, state)  # the step donates its state
        state, d, g = engine._train_step(state, _stack(batches), K, key)
        runs.append({"d": np.asarray(d), "g": float(g), "after": _ku_state(state), "eps": eps})
    return groups, before, runs


def _port_from(mode, state, **hps):
    engine = _port(mode, **hps)
    engine.init_state()
    return state_from_ku(engine, state)


# -- the step against ku's, mode by mode ----------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_losses_and_gradients_match_ku(mode):
    groups, before, _ = _ku_run(mode)
    batch = groups[0][0]
    ku = _ku(mode)
    ku.init_state(jax.tree.map(jnp.asarray, batch), seed=0)
    kb = jax.tree.map(jnp.asarray, batch)
    key = jax.random.key(3)
    d_ku, dg_ku = jax.jit(jax.value_and_grad(ku._disc_loss))(ku.state["disc_params"], ku.state,
                                                              kb, key)
    (g_ku, _), gg_ku = jax.jit(jax.value_and_grad(ku._gen_loss, has_aux=True))(
        ku.state["gen_params"], ku.state, kb, jax.random.fold_in(key, 1))

    engine = _port_from(mode, before)
    _feed_eps(engine, [np.asarray(jax.random.uniform(jax.random.fold_in(key, 7), (16, 1)))])
    pb = _port_batch(batch)
    draws = engine.state["gen"].generator
    d = engine._disc_loss(pb, draws)
    dg = torch.autograd.grad(d, list(engine.disc.parameters()))
    g = engine._gen_loss(pb, draws)
    gg = torch.autograd.grad(g, list(engine.gen.parameters()))
    _close(d, d_ku, what="D loss")
    _close(g, g_ku, what="G loss")
    names = [n.replace(".", "/") for n, _ in engine.disc.named_parameters()]
    _close_tree(dict(zip(names, dg)), _flatten(_np(dg_ku)), what="D grads")
    names = [n.replace(".", "/") for n, _ in engine.gen.named_parameters()]
    _close_tree(dict(zip(names, gg)), _flatten(_np(gg_ku)), what="G grads")


@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_ku(mode):
    """k = 2 D updates and one G update on the fresh third batch: the D
    losses, the G loss, the params, Adam's moments and counts, the step."""
    groups, before, runs = _ku_run(mode)
    engine = _port_from(mode, before)
    _feed_eps(engine, runs[0]["eps"])
    d, g = engine.train_step([_port_batch(b) for b in groups[0]], K)
    assert d.shape == (K,)
    worst = {"losses": max(_close(d, runs[0]["d"], what="D losses"),
                           _close(g, runs[0]["g"], what="G loss"))}
    got = state_to_ku(engine)
    want = runs[0]["after"]
    assert int(got["step"]) == int(want["step"]) == 1
    for side in ("gen", "disc"):
        worst[f"{side} params"] = _close_tree(got[f"{side}_params"], want[f"{side}_params"],
                                              what=f"{side} params")
        assert int(got[f"{side}_opt"]["count"]) == int(want[f"{side}_opt"]["count"])
        for m in ("mu", "nu"):
            worst[f"{side} {m}"] = _close_tree(got[f"{side}_opt"][m], want[f"{side}_opt"][m],
                                               what=f"{side} {m}")
    print(f"mode {mode}: worst |port - ku| over each tensor's largest entry:",
          {k: f"{v:.2e}" for k, v in worst.items()})


def test_adam_state_carried_across():
    """Load ku's state after its step 1 (Adam count 1 and 2), take step 2
    in the port, and hold it against ku's step 2: the bias corrections and
    the carried moments."""
    groups, _, runs = _ku_run(STYLE_GAN_SOFTPLUS_INVERSE_R1_GP, steps=2)
    engine = _port_from(STYLE_GAN_SOFTPLUS_INVERSE_R1_GP, runs[0]["after"])
    assert engine.state["gen"].step == 1 and engine.state["disc"].step == K
    d, g = engine.train_step([_port_batch(b) for b in groups[1]], K)
    _close(d, runs[1]["d"], what="D losses")
    _close(g, runs[1]["g"], what="G loss")
    got, want = state_to_ku(engine), runs[1]["after"]
    assert int(got["step"]) == 2 and int(got["disc_opt"]["count"]) == 2 * K
    for side in ("gen", "disc"):
        _close_tree(got[f"{side}_params"], want[f"{side}_params"], what=side)
        _close_tree(got[f"{side}_opt"]["nu"], want[f"{side}_opt"]["nu"], what=f"{side} nu")


def test_state_round_trip():
    _, before, runs = _ku_run(STYLE_GAN_SOFTPLUS_INVERSE_R1_GP, steps=2)
    for state in (before, runs[0]["after"]):
        got = state_to_ku(_port_from(STYLE_GAN_SOFTPLUS_INVERSE_R1_GP, state))
        _close_tree(got, state, rel=0.0)


def test_multi_step_equals_single_steps():
    """``train_multi_step`` over S = 3 groups equals three ``train_step``s
    bit for bit, and ku's jitted scan over the same groups within REL."""
    mode = LSGAN
    rng = np.random.default_rng(4)
    it = _data_iter(rng, mode)
    groups = [[next(it) for _ in range(K + 1)] for _ in range(3)]
    ku = _ku(mode)
    ku.init_state(jax.tree.map(jnp.asarray, groups[0][0]), seed=0)
    before = _ku_state(ku.state)
    st, d_ku, g_ku = ku._train_multi_step(ku.state, _stack([_stack(b) for b in groups]), K,
                                          jax.random.key(5))

    multi = _port_from(mode, before)
    d, g = multi.train_multi_step([[_port_batch(b) for b in gr] for gr in groups], K)
    single = _port_from(mode, before)
    singles = [single.train_step([_port_batch(b) for b in gr], K) for gr in groups]
    assert d.shape == (3, K) and g.shape == (3,)
    assert torch.equal(d, torch.stack([s[0] for s in singles]))
    assert torch.equal(g, torch.stack([s[1] for s in singles]))
    for p, q in zip(multi.gen.parameters(), single.gen.parameters()):
        assert torch.equal(p, q)
    _close(d, d_ku, what="D losses")
    _close(g, g_ku, what="G losses")
    _close_tree(state_to_ku(multi)["gen_params"], _np(st["gen_params"]), what="gen params")


# -- the loops -------------------------------------------------------------------


class _Recorder:
    def __init__(self, stop_after=None):
        self.calls = []
        self.stop_after = stop_after

    def on_train_begin(self, engine):
        self.calls.append(("begin",))

    def on_train_batch_end(self, engine, step, logs):
        self.calls.append(("batch", step, sorted(logs)))

    def on_epoch_end(self, engine, epoch, logs):
        self.calls.append(("epoch", epoch, sorted(logs)))
        if self.stop_after is not None and epoch >= self.stop_after:
            engine.stop_training = True

    def on_train_end(self, engine, history):
        self.calls.append(("end", len(history["disc_ext_loss"])))


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_fit_generator_history_format(capsys, steps_per_call):
    """ku's history (one mean an epoch per loss), its per-epoch line and
    its callbacks; the fused loop's history equals the step-by-step one."""
    runs = []
    for spc in (1, steps_per_call):
        engine = _port(STYLE_GAN_SOFTPLUS_INVERSE_R1_GP, epochs=3, batch_step=3,
                       steps_per_call=spc)
        rec = _Recorder(stop_after=1)
        history = engine.fit_generator(
            _data_iter(np.random.default_rng(0), STYLE_GAN_SOFTPLUS_INVERSE_R1_GP),
            verbose=1, callbacks=[rec])
        runs.append(history)
    assert sorted(history) == ["disc_ext_loss", "gen_disc_loss"]
    assert len(history["disc_ext_loss"]) == len(history["gen_disc_loss"]) == 2
    assert np.isfinite(history["disc_ext_loss"]).all()
    assert runs[0] == runs[1]
    logs = ["disc_ext_loss", "gen_disc_loss"]
    assert rec.calls == ([("begin",)] + [("batch", s, logs) for s in range(3)]
                         + [("epoch", 0, logs)] + [("batch", s, logs) for s in range(3)]
                         + [("epoch", 1, logs), ("end", 2)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"Epoch 1/3, disc_ext loss: {history['disc_ext_loss'][0]:f}, "
                      f"gen_disc loss: {history['gen_disc_loss'][0]:f}")
    assert engine.state["gen"].step == 6 and engine.state["disc"].step == 6 * K


def test_fit_generator_resumes_after_the_restored_epoch():
    class Restore(_Recorder):
        def maybe_restore(self, engine):
            return 1

    engine = _port(LSGAN, epochs=3, batch_step=2)
    rec = Restore()
    history = engine.fit_generator(_data_iter(np.random.default_rng(0), LSGAN), verbose=0,
                                   callbacks=[rec], initial_epoch="auto")
    assert len(history["disc_ext_loss"]) == 1
    assert [c[1] for c in rec.calls if c[0] == "epoch"] == [2]


def test_gan_learns_mean():
    """Non-saturating GAN on N(2, .5) data (tests/test_gan.py:85-103): the
    generator's mean moves from ~0 toward the data's."""
    conf = {"hps": {"composing_mode": STYLE_GAN_REGULAR, "epochs": 30, "batch_step": 8,
                    "disc_k_step": 1,
                    "disc_ext_hps": {"lr": 2e-3, "beta_1": 0.5, "beta_2": 0.999},
                    "gen_disc_hps": {"lr": 2e-3, "beta_1": 0.5, "beta_2": 0.999}}}
    engine = GAN(conf, ToyGen(), ToyDisc()).compose_gan_with_mode().compile()
    rng = np.random.default_rng(0)
    z_fixed = rng.normal(size=(64, 4)).astype(np.float32)
    before = float(engine.generate(z_fixed).mean())
    engine.fit_generator(_data_iter(rng, STYLE_GAN_REGULAR), verbose=0)
    out = engine.generate(z_fixed)
    assert out.shape == (64, 8)
    mean_after = float(out.mean())
    assert abs(before) < 0.8
    assert mean_after > 0.8, f"generator mean {mean_after} did not move toward 2.0"


def test_mesh_is_not_ported():
    engine = _port(LSGAN)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 6"):
        engine.fit_generator(_data_iter(np.random.default_rng(0), LSGAN), mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 6"):
        engine.fit_generator_progressively(lambda *a: None, mesh=object())


# -- R1: lazy, always-on in evaluation; ku's memory knobs --------------------------


@pytest.mark.parametrize("interval", [1, 4])
def test_lazy_r1_interval(interval):
    """The D loss against ku's at steps 0 and 1: every `interval` steps the
    penalty scaled by the interval, else none; interval 1 is the default."""
    mode = STYLE_GAN_SOFTPLUS_INVERSE_R1_GP
    groups, before, _ = _ku_run(mode)
    kb = jax.tree.map(jnp.asarray, groups[0][0])
    ku = _ku(mode, r1_interval=interval)
    ku.init_state(kb, seed=0)
    ku_loss = jax.jit(ku._disc_loss)
    engine = _port_from(mode, before, r1_interval=interval)
    default = _port_from(mode, before)
    pb = _port_batch(groups[0][0])
    draws = engine.state["gen"].generator
    for step in (0, 1):
        want = ku_loss(ku.state["disc_params"], {**ku.state, "step": jnp.int32(step)}, kb,
                       jax.random.key(2))
        engine.state["gen"].step = default.state["gen"].step = step
        got = engine._disc_loss(pb, draws)
        _close(got, want, what=f"step {step}")
        if interval == 1:
            assert float(got.detach()) == float(default._disc_loss(pb, draws).detach())


def test_evaluate_uses_always_on_r1():
    """evaluate() reports the always-on R1 loss whatever the lazy interval
    and the step, equal to ku's evaluate; it changes no parameter, buffer
    or draw of the state."""
    mode = STYLE_GAN_SOFTPLUS_INVERSE_R1_GP
    groups, before, _ = _ku_run(mode)
    batch = groups[0][0]
    ku = _ku(mode)
    ku.init_state(jax.tree.map(jnp.asarray, batch), seed=0)
    want = ku.evaluate(iter([batch] * 2), steps=2, seed=4)

    def eval_loss(step, **hps):
        e = _port_from(mode, before, **hps)
        e.state["gen"].step = step
        return e, e.evaluate(iter([batch] * 2), steps=2, seed=4)

    e, always = eval_loss(7)
    params = [p.clone() for p in e.gen.parameters()]
    draws = e.state["gen"].generator.get_state()
    again = e.evaluate(iter([batch] * 2), steps=2, seed=4)
    assert again == always
    assert all(torch.equal(p, q) for p, q in zip(params, e.gen.parameters()))
    assert torch.equal(draws, e.state["gen"].generator.get_state())
    for step in (7, 16):
        assert eval_loss(step, r1_interval=16)[1] == always
    for k in want:
        _close(always[k], want[k], what=k)


def test_evaluate_refuses_without_state():
    with pytest.raises(RuntimeError, match="requires initialized state"):
        _port(LSGAN).evaluate(_data_iter(np.random.default_rng(0), LSGAN))


KNOBS = [(STYLE_GAN_SOFTPLUS_INVERSE_R1_GP, (("r1_fused_vjp", True),))] + [
    (mode, (("remat", policy),)) for mode in (STYLE_GAN_SOFTPLUS_INVERSE_R1_GP, STYLE_GAN_WGAN_GP)
    for policy in ("dots", "dots_no_batch", "nothing")]


@pytest.mark.parametrize("mode,knobs", KNOBS)
def test_memory_knobs_leave_the_step_as_ku_takes_it(mode, knobs):
    """ku's ``r1_fused_vjp`` and ``remat`` change what its step recomputes,
    never the values. The port accepts the conf keys and computes the same
    function: its step equals ku's jitted step with the knob set."""
    groups, before, runs = _ku_run(mode, **dict(knobs))
    engine = _port_from(mode, before, **dict(knobs))
    _feed_eps(engine, runs[0]["eps"])
    d, g = engine.train_step([_port_batch(b) for b in groups[0]], K)
    _close(d, runs[0]["d"], what="D losses")
    _close(g, runs[0]["g"], what="G loss")
    got, want = state_to_ku(engine), runs[0]["after"]
    for side in ("gen", "disc"):
        _close_tree(got[f"{side}_params"], want[f"{side}_params"], what=f"{side} params")


def test_wgan_interpolation_draws():
    """The port's own ε: one U[0, 1) draw a sample, broadcast over the rest."""
    engine = _port(STYLE_GAN_WGAN_GP)
    engine.init_state(seed=0)
    x = torch.zeros(20000, 3, 2)
    eps = engine._interp_eps(x, engine.state["gen"].generator)
    assert eps.shape == (20000, 1, 1) and eps.dtype == x.dtype
    assert float(eps.min()) >= 0.0 and float(eps.max()) < 1.0
    assert abs(float(eps.mean()) - 0.5) < 0.01
    assert abs(float(eps.var()) - 1.0 / 12.0) < 0.005


# -- persistence and the state -------------------------------------------------------


@pytest.mark.parametrize("writer", ["ku", "port"])
def test_save_load_round_trip_with_ku(tmp_path, writer):
    """Each package reads the other's ``gen_disc.npz`` / ``disc_ext.npz``:
    the same samples from the loaded generator."""
    mode = LSGAN
    rng = np.random.default_rng(1)
    z = rng.normal(size=(4, 4)).astype(np.float32)
    if writer == "ku":
        src = _ku(mode, epochs=1, batch_step=2, disc_k_step=1)
        src.fit_generator(_data_iter(rng, mode), verbose=0)
        src.save_gan_model(str(tmp_path))
        want = np.asarray(src.generate(jnp.asarray(z)))
        dst = _port(mode).load_gan_model(str(tmp_path))
        got = dst.generate(z).numpy()
        assert dst.state["gen"].optimizer is not None
    else:
        src = _port(mode, epochs=1, batch_step=2, disc_k_step=1)
        src.fit_generator(_data_iter(rng, mode), verbose=0)
        src.save_gan_model(str(tmp_path))
        want = src.generate(z).numpy()
        dst = _ku(mode).load_gan_model(str(tmp_path))
        got = np.asarray(dst.generate(jnp.asarray(z)))
    _close(got, want, rel=1e-6)


def test_load_before_compile_then_fit(tmp_path):
    """load_gan_model() before compile() leaves the optimizers unset;
    compile() builds them and the engine trains."""
    rng = np.random.default_rng(2)
    src = _port(LSGAN, epochs=1, batch_step=2, disc_k_step=1)
    src.fit_generator(_data_iter(rng, LSGAN), verbose=0)
    src.save_gan_model(str(tmp_path))
    conf = {"hps": dict(HPS, composing_mode=LSGAN, epochs=1, batch_step=2, disc_k_step=1)}
    engine = GAN(conf, ToyGen(seed=5), ToyDisc(seed=6)).compose_gan_with_mode()
    engine.load_gan_model(str(tmp_path))
    assert engine.state["gen"].optimizer is None and engine.state["disc"].optimizer is None
    for p, q in zip(engine.gen.parameters(), src.gen.parameters()):
        assert torch.equal(p, q)
    engine.compile()
    assert engine.state["gen"].optimizer is not None
    assert engine.state["disc"].optimizer is not None
    h = engine.fit_generator(_data_iter(rng, LSGAN), verbose=0)
    assert np.isfinite(h["disc_ext_loss"]).all()


def test_train_state_create_and_apply_gradients():
    """One Adam step with the given gradients, step + 1, the gradients
    dropped; the optimizer is the one ``adam`` builds."""
    w = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    draws = torch.Generator().manual_seed(0)
    st = TrainState.create([w], adam(0.1), draws)
    assert st.step == 0 and st.generator is draws
    assert isinstance(st.optimizer, torch.optim.Adam)
    st.apply_gradients([torch.tensor([0.5, -0.25])])
    assert st.step == 1 and w.grad is None
    _close(w.detach(), np.array([0.9, -1.9], np.float32), rel=1e-6)


def test_compose_gan_with_mode_wrapper():
    engine = compose_gan_with_mode(ToyGen(), ToyDisc(), STYLE_GAN_REGULAR)
    assert engine.composing_mode == STYLE_GAN_REGULAR
    assert engine.hps["composing_mode"] == STYLE_GAN_REGULAR
    assert "disc_ext_losses" in engine.loss_conf


def test_get_loss_conf_matches_ku():
    """Loss lists, weights and penalty tags as ku's, and each loss the
    same function on the same logits."""
    hps = {"r_gamma": 5.0, "wgan_lambda": 7.0, "wgan_target": 2.0}
    y = np.random.default_rng(0).normal(size=(6, 1)).astype(np.float32)
    for t in range(4):
        lc, ku_lc = get_loss_conf(hps, t), ku_get_loss_conf(hps, t)
        assert sorted(lc) == sorted(ku_lc)
        for key in ("disc_ext_loss_weights", "gen_disc_loss_weights"):
            assert lc[key] == ku_lc[key]
        for key in ("disc_ext_losses", "gen_disc_losses"):
            assert len(lc[key]) == len(ku_lc[key])
            for fn, ku_fn in zip(lc[key], ku_lc[key]):
                if isinstance(ku_fn, tuple):
                    assert fn == ku_fn
                    continue
                for target in (0.0, 1.0):
                    _close(fn(torch.full((6, 1), target), torch.from_numpy(y)),
                           ku_fn(jnp.full((6, 1), target), jnp.asarray(y)), rel=1e-6)
    with pytest.raises(ValueError):
        get_loss_conf(hps, 99)


def test_merge_shared_matches_ku():
    rng = np.random.default_rng(0)
    new = {"a": {"kernel": np.zeros((2, 3)), "bias": np.zeros(3)},
           "b": {"kernel": np.zeros((4, 4))}, "c": np.zeros(2)}
    old = {"a": {"kernel": rng.normal(size=(2, 3)), "bias": rng.normal(size=4)},
           "b": {"kernel": rng.normal(size=(4, 4))}, "d": rng.normal(size=2)}
    got, want = _merge_shared(new, old), ku_merge_shared(new, old)
    _close_tree(got, _np(want), rel=0.0)
    assert got["a"]["kernel"] is old["a"]["kernel"] and got["a"]["bias"] is new["a"]["bias"]


def test_progressive_carries_shared_params():
    """Each stage rebuilds the modules; the parameters that keep their
    names and shapes start the stage from the previous stage's values, the
    others from the new modules' own."""
    built = []

    def factory(e, g_depth, d_depth):
        gen, disc = ToyGen(hidden=g_depth, seed=10 + e), ToyDisc(hidden=d_depth, seed=20 + e)
        built.append((gen, disc, {n: p.detach().clone() for n, p in gen.named_parameters()}))
        return gen, disc, _data_iter(np.random.default_rng(e), LSGAN)

    seen = []

    class Stage(_Recorder):
        def on_train_begin(self, engine):
            seen.append({n: p.detach().clone() for n, p in engine.gen.named_parameters()})

    engine = _port(LSGAN, epochs=3, batch_step=2, disc_k_step=1)
    history = engine.fit_generator_progressively(factory, gen_prog_depths=(16, 16, 8),
                                                 disc_prog_depths=(16, 16, 16), verbose=0,
                                                 callbacks=[Stage()])
    assert len(history) == 3 and [len(h["disc_ext_loss"]) for h in history] == [1, 1, 1]
    trained = {}
    for e, (gen, _, fresh) in enumerate(built):
        start = seen[e]
        for name in fresh:
            want = trained.get(name) if e else None
            if want is None or want.shape != fresh[name].shape:
                want = fresh[name]
            assert torch.equal(start[name], want), (e, name)
        trained = {n: p.detach().clone() for n, p in gen.named_parameters()}
    assert engine.gen is built[-1][0]


def test_progressive_resumes_after_the_latest_stage():
    """``initial_epoch="auto"``: the latest checkpointed stage is rebuilt
    through the factory and restored, and training goes on at the next."""
    stages = []

    def factory(e, g_depth, d_depth):
        stages.append(e)
        return ToyGen(seed=e), ToyDisc(seed=e), _data_iter(np.random.default_rng(e), LSGAN)

    class Checkpoint(_Recorder):
        class mgr:
            @staticmethod
            def latest_step():
                return 1

        def maybe_restore(self, engine):
            self.restored_into = engine.gen
            return 1

    ckpt = Checkpoint()
    engine = _port(LSGAN, epochs=3, batch_step=1, disc_k_step=1)
    history = engine.fit_generator_progressively(factory, verbose=0, callbacks=[ckpt],
                                                 initial_epoch="auto")
    assert stages == [1, 2] and len(history) == 1
    assert [c[1] for c in ckpt.calls if c[0] == "epoch"] == [2]
    assert ckpt.restored_into is not engine.gen
