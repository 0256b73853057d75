"""ku_torch's GAN step on StyleGAN against ku's, on the CPU.

tests/test_torch_stylegan.py's TEST_CONF (16 px) in the softplus-R1 mode
with k = 2 D steps, batch 4, ku's step jitted. Noise and style mixing
cannot draw JAX's numbers, so both packages run with ``mixing_prob=None``
and every noise weight 0: in step 1 the noise then changes no output and
no gradient but the noise weights' own. Adam with β1 = 0 moves each of
those by lr·g/(|g| + 1e-8), about ±lr, with a sign set by each package's
own noise, so they are held to |w| <= lr and nothing else.

Tolerance: 1e-4 of each tensor's largest entry (REL), as for the models
alone (f32 through the whole generator and discriminator, and R1's second
order). The moving mean starts away from zero, so that the truncation
matters, and the learned constant is drawn from N(0, 1): with the noise
off, ku's constant of ones makes the first AdaIN's σ exactly 0, where the
gradient of σ is NaN in both packages.

Three tests pin where a literal translation of ku's step would compute
another function: the D steps' fakes leave the truncation buffer as it
was, they are k generator calls (each its own truncation batch mean), and
D(real) and D(fake) are two discriminator passes (the minibatch-stddev
groups never mix them).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ku.backprop import GAN as KuGAN
from ku.backprop import STYLE_GAN_SOFTPLUS_INVERSE_R1_GP
from ku.models import StyleGANDiscriminator as KuDisc
from ku.models import StyleGANGenerator as KuGen
from ku_torch.backprop import GAN, state_from_ku, state_to_ku
from ku_torch.models import StyleGANDiscriminator, StyleGANGenerator
from ku_torch.utility import _flatten

REL = 1e-4
CPU = "cpu"
K, B, LR = 2, 4, 1e-3
CONF = dict(resolution=16, ch_base=64, max_ch=32, latent_dim=16, dlatent_dim=32,
            dense1_dim=32, num_mapping_layers=3, num_classes=10, label_usage=True,
            mixing_prob=None, trunc_psi=0.7, trunc_cutoff=4)
DISC = dict(resolution=16, ch_base=64, max_ch=32, label_usage=True)
ENGINE = {
    "hps": {"composing_mode": STYLE_GAN_SOFTPLUS_INVERSE_R1_GP, "disc_k_step": K,
            "r_gamma": 10.0, "r1_interval": 1,
            "disc_ext_hps": {"lr": LR, "beta_1": 0.0, "beta_2": 0.99},
            "gen_disc_hps": {"lr": LR, "beta_1": 0.0, "beta_2": 0.99}},
    "nn_arch": {"gen_rng_streams": ["noise", "style"]},
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(seed=0):
    """K + 1 batches as benchmarks/stylegan_lane_packing.py's
    ``batches_stacked`` makes them, at this conf's widths."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(K + 1):
        x = rng.normal(size=(B, 16, 16, 3)).astype(np.float32)
        z1 = rng.normal(size=(B, CONF["latent_dim"])).astype(np.float32)
        z2 = rng.normal(size=(B, CONF["latent_dim"])).astype(np.float32)
        label = rng.integers(0, CONF["num_classes"], size=(B, 1))
        out.append({"x": x, "z": (z1, label, z2), "label": label.astype(np.float32)})
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ku_state(state):
    out = _np({k: v for k, v in state.items() if not k.endswith("_opt")})
    for side in ("gen_opt", "disc_opt"):
        adam_state = state[side][0]
        out[side] = _np({"count": adam_state.count, "mu": adam_state.mu,
                         "nu": adam_state.nu})
    return out


@functools.lru_cache(maxsize=None)
def _ku():
    """ku's engine and its state with every noise weight 0 and the moving
    mean drawn away from zero."""
    engine = KuGAN(ENGINE, KuGen(**CONF), KuDisc(**DISC)).compose_gan_with_mode().compile()
    engine.init_state(jax.tree.map(jnp.asarray, _batches()[0]), seed=0)
    state = dict(engine.state)
    state["gen_params"] = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.zeros_like(v) if path[-1].key == "noise_weight" else v,
        state["gen_params"])
    const = state["gen_params"]["synthesis"]["const_input"]
    state["gen_params"]["synthesis"]["const_input"] = jnp.asarray(
        np.random.default_rng(6).normal(size=const.shape).astype(np.float32))
    mm = state["gen_stats"]["truncation"]["moving_mean"]
    state["gen_stats"] = {"truncation": {"moving_mean": jnp.asarray(
        np.random.default_rng(5).normal(size=mm.shape).astype(np.float32))}}
    engine.state = state
    return engine


def _stack(batches):
    return jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *batches)


@functools.lru_cache(maxsize=None)
def _ku_step():
    """ku's jitted step; and the gradient each of its updates takes: D at
    the state before the step, D after one D update (through ku's
    optimizer), G at the state the G update sees. With the noise weights 0
    and no mixing the fakes do not depend on the key."""
    engine = _ku()
    before = _ku_state(engine.state)
    state = jax.tree.map(jnp.copy, engine.state)  # the step donates its state
    out, d, g = engine._train_step(state, _stack(_batches()), K, jax.random.key(7))
    after = _ku_state(out)
    state = engine.state
    batches = [jax.tree.map(jnp.asarray, b) for b in _batches()]
    fakes = jnp.asarray(_ku_fakes())
    d_grad = jax.jit(jax.value_and_grad(engine._disc_loss))
    params, opt, d_grads = state["disc_params"], state["disc_opt"], []
    for i in range(K):
        _, g_i = d_grad(params, state, batches[i], jax.random.key(3), fakes[i])
        d_grads.append(_flatten(_np(g_i)))
        updates, opt = engine.disc_opt.update(g_i, opt, params)
        params = optax.apply_updates(params, updates)
    _, g_grads = jax.jit(jax.value_and_grad(engine._gen_loss, has_aux=True))(
        state["gen_params"], dict(state, disc_params=params), batches[K], jax.random.key(8))
    return before, np.asarray(d), float(g), after, d_grads, _flatten(_np(g_grads))


def _port():
    engine = GAN(ENGINE, StyleGANGenerator(**CONF, device=CPU),
                 StyleGANDiscriminator(**DISC, device=CPU)).compose_gan_with_mode().compile()
    engine.init_state(seed=0)
    return state_from_ku(engine, _ku_state(_ku().state))


def _port_batch(batch):
    return {"x": torch.from_numpy(batch["x"]),
            "z": tuple(torch.from_numpy(np.asarray(a)) for a in batch["z"]),
            "label": torch.from_numpy(batch["label"])}


def _close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max(initial=0)), float(np.abs(want).max(initial=0))
    assert err <= rel * scale, f"{what}: max abs diff {err} > {rel} x {scale}"
    return err / scale if scale else 0.0


def _grads(loss, module):
    grads = torch.autograd.grad(loss, list(module.parameters()), allow_unused=True,
                                materialize_grads=True)
    return {n.replace(".", "/"): g for (n, _), g in zip(module.named_parameters(), grads)}


def _grad_tolerances(grads, batch):
    """δ a gradient tensor is held to: REL of its largest entry; for the
    discriminator's output bias, a difference of the real rows' and the
    fake rows' terms, 8 f32 ulps (2^-20) of their summed magnitude, at most
    2·Σ|label|/B (softplus' slope is at most 1, each row's logit is scaled
    by its label)."""
    out = {name: REL * np.abs(g).max() for name, g in grads.items()}
    if "dense_out/bias" in out:
        bound = 2.0 * np.abs(batch["label"]).sum() / B
        out["dense_out/bias"] = max(out["dense_out/bias"], 2.0 ** -20 * bound)
    return out


def _hold_grads(got, want, deltas, what, skip=()):
    assert got.keys() == want.keys(), what
    for name in want:
        if not name.endswith(skip):
            err = float(np.abs(got[name].numpy() - want[name]).max())
            assert err <= deltas[name], f"{what} {name}: max abs diff {err} > {deltas[name]}"


def _adam_spread(grads, deltas, b2=0.99, eps=1e-8):
    """The widest change of the sum of an entry's Adam updates (β1 = 0, ku's
    β2 and ε) when each update's gradient moves within ±deltas[s] of
    grads[s]: a grid of 9 points a step. Where a gradient's range holds 0,
    the update can take either sign: there the bound is the whole range,
    twice the sum of the largest updates, LR·sqrt((1 - β2^t) / (1 - β2)) at
    step t."""
    def total(gs):
        v, out = 0.0, 0.0
        for t, g in enumerate(gs, 1):
            v = b2 * v + (1 - b2) * g * g
            out = out + LR * g / (np.sqrt(v / (1 - b2 ** t)) + eps)
        return out

    nominal = total(grads)
    spread = np.zeros_like(nominal)
    offsets = np.linspace(-1.0, 1.0, 9)
    for point in np.stack(np.meshgrid(*[offsets] * len(grads)), -1).reshape(-1, len(grads)):
        moved = total([g + o * d for g, o, d in zip(grads, point, deltas)])
        spread = np.maximum(spread, np.abs(moved - nominal))
    crosses = np.any([np.abs(g) <= d for g, d in zip(grads, deltas)], axis=0)
    whole = 2 * LR * sum(np.sqrt((1 - b2 ** t) / (1 - b2)) for t in range(1, len(grads) + 1))
    return np.where(crosses, whole, spread)


def _hold_params(got, want, before, grads, deltas, what):
    """Each entry's change over the step (after - before) within REL of the
    largest entry of ku's change, plus the widest change of its Adam
    updates over gradients within their own tolerances, plus both
    packages' f32 rounding of each update (2^-24 of the entry's magnitude);
    returns the largest share of its tolerance an entry takes. A skipped
    update, or one of the wrong sign, misses by about LR."""
    assert got.keys() == want.keys(), what
    worst, n = 0.0, len(grads)
    for name in want:
        start = before[name].astype(np.float64)
        change = want[name] - start
        tol = (REL * np.abs(change).max()
               + _adam_spread([g[name] for g in grads], [d[name] for d in deltas])
               + 2 * n * 2.0 ** -24 * (np.abs(start) + 2 * n * LR))
        err = np.abs((got[name] - start) - change)
        assert (err <= tol).all(), (what, name, float((err - tol).max()))
        worst = max(worst, float((err / tol).max()))
    return worst


def test_train_step_matches_ku():
    """One step: the D losses, the G loss and the moving mean within REL;
    the gradient of each of the k + 1 updates (the port's own step taken
    piece by piece) within its tolerance (:func:`_grad_tolerances`); every
    updated parameter within REL of its tensor's largest entry plus what
    each parameter's change over the step within REL of ku's change's
    largest entry plus what those gradient tolerances can move Adam's
    updates by (:func:`_hold_params`); the noise weights by the rule in the
    module docstring.

    Why the changes need more than REL: Adam's first update with β1 = 0,
    lr·g/(|g| + ε), has a slope of 1e5 at g = 0, so an entry whose gradient
    sits within rounding of 0 can move by up to 2·lr between the packages;
    one generator bias entry here does, by far more than REL of the largest
    entry of its tensor's change."""
    before, d_ku, g_ku, after, d_grads_ku, g_grads_ku = _ku_step()
    pieces = _port()
    draws = pieces.state["gen"].generator
    batches = [_port_batch(b) for b in _batches()]
    d_deltas = [_grad_tolerances(g, b) for g, b in zip(d_grads_ku, _batches())]
    for i, (batch, fake) in enumerate(zip(batches, pieces._gen_fakes(batches[:K], draws))):
        grads = _grads(pieces._disc_loss(batch, draws, fake), pieces.disc)
        _hold_grads(grads, d_grads_ku[i], d_deltas[i], f"D update {i} gradient")
        pieces.state["disc"].apply_gradients(list(grads.values()))
    grads = _grads(pieces._gen_loss(batches[K], draws), pieces.gen)
    g_deltas = _grad_tolerances(g_grads_ku, _batches()[K])
    _hold_grads(grads, g_grads_ku, g_deltas, "G gradient", skip="noise_weight")

    engine = _port()
    d, g = engine.train_step(batches, K)
    worst = {"D losses": _close(d, d_ku, what="D losses"),
             "G loss": _close(g, g_ku, what="G loss")}
    got = state_to_ku(engine)
    assert int(got["step"]) == int(after["step"]) == 1
    worst["moving mean"] = _close(got["gen_stats"]["truncation"]["moving_mean"],
                                  after["gen_stats"]["truncation"]["moving_mean"],
                                  what="moving mean")
    share = {"disc": _hold_params(_flatten(got["disc_params"]), _flatten(after["disc_params"]),
                                  _flatten(before["disc_params"]), d_grads_ku, d_deltas,
                                  "disc")}
    gen, gen_ku = _flatten(got["gen_params"]), _flatten(after["gen_params"])
    noise = {n for n in gen_ku if n.endswith("noise_weight")}
    for name in noise:
        for w in (gen[name], gen_ku[name]):
            assert np.abs(w).max() <= LR * (1 + 1e-5), name
    keep = lambda flat: {k: v for k, v in flat.items() if k not in noise}  # noqa: E731
    share["gen"] = _hold_params(keep(gen), keep(gen_ku), keep(_flatten(before["gen_params"])),
                                [g_grads_ku], [g_deltas], "gen")
    print("StyleGAN step: |port - ku| over the largest entry:",
          {k: f"{v:.2e}" for k, v in worst.items()},
          "; parameters, the largest share of their tolerance:",
          {k: f"{v:.2e}" for k, v in share.items()})


def test_d_step_fakes_keep_the_truncation_buffer():
    """The D steps' fakes are made in training mode, yet the moving mean
    after them is the one before them (ku drops their ``batch_stats``)."""
    engine = _port()
    mean = engine.gen.truncation.moving_mean.clone()
    engine._gen_fakes([_port_batch(b) for b in _batches()[:K]],
                      engine.state["gen"].generator)
    assert torch.equal(engine.gen.truncation.moving_mean, mean)


@functools.lru_cache(maxsize=None)
def _ku_fakes():
    engine = _ku()
    key = jax.random.key(7)
    d_keys = jnp.stack([jax.random.fold_in(key, i) for i in range(K)])
    d_stack = _stack(_batches()[:K])
    return np.asarray(jax.jit(jax.vmap(lambda b, kk: engine._gen_fake(engine.state, b, kk)))(
        d_stack, d_keys))


def test_k_fakes_are_k_generator_calls():
    """Each D step's fake equals ku's vmapped slice: truncated toward the
    mean updated by that batch alone."""
    engine = _port()
    fakes = engine._gen_fakes([_port_batch(b) for b in _batches()[:K]],
                              engine.state["gen"].generator)
    want = _ku_fakes()
    for i, fake in enumerate(fakes):
        _close(fake, want[i], what=f"fake {i}")


@functools.lru_cache(maxsize=None)
def _ku_disc_loss():
    engine = _ku()
    batch = jax.tree.map(jnp.asarray, _batches()[0])
    fake = jnp.asarray(_ku_fakes()[0])
    loss, grads = jax.jit(jax.value_and_grad(engine._disc_loss))(
        engine.state["disc_params"], engine.state, batch, jax.random.key(3), fake)
    return float(loss), _flatten(_np(grads))


def test_real_and_fake_take_two_discriminator_passes():
    """The D loss and its gradients on ku's fake equal ku's (gradients
    within :func:`_grad_tolerances`), whose discriminator sees the real and
    the fake rows in separate groups."""
    engine = _port()
    loss = engine._disc_loss(_port_batch(_batches()[0]), engine.state["gen"].generator,
                             fake=torch.from_numpy(np.array(_ku_fakes()[0])))
    want_loss, want_grads = _ku_disc_loss()
    _close(loss, want_loss, what="D loss")
    _hold_grads(_grads(loss, engine.disc), want_grads,
                _grad_tolerances(want_grads, _batches()[0]), "D gradient")
