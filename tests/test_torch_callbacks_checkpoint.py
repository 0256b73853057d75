"""ku_torch's callbacks, checkpoints and tracing, on the CPU.

- ``History``, ``EarlyStopping`` and ``LambdaCallback`` in
  ``GAN.fit_generator`` on tests/test_torch_gan.py's toy MLP GAN, against
  ku's engine run from the same state (carried by ``state_from_ku``) on the
  same batches: the logs by epoch within 1e-5 of ku's (REL, as
  tests/test_torch_gan.py holds one step), the same epochs, stops and call
  sequence.
- Resume: a run checkpointed by ``CheckpointCallback``, cut after an epoch
  and resumed by a fresh engine with ``initial_epoch="auto"``, equals the
  uninterrupted run bit for bit (parameters, Adam's moments and steps, the
  draws' generator, which WGAN-GP's interpolation reads); and the
  progressive loop goes on at the stage after the last complete
  checkpoint, again bit for bit.
- ``CheckpointManager``: a half-written step is never read and is swept
  only on restore; ``max_to_keep``; ``save_interval_steps``; a process that
  saves in a loop, SIGKILLed at a random moment, leaves the last complete
  step readable bit for bit.
- ``trace`` / ``step_trace`` regions in ``torch.profiler``'s events, and
  ``start_profile`` / ``stop_profile``'s Chrome trace.
"""

import functools
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ku.backprop import GAN as KuGAN
from ku.utils.callbacks import EarlyStopping as KuEarlyStopping
from ku.utils.callbacks import History as KuHistory
from ku.utils.callbacks import LambdaCallback as KuLambdaCallback
from ku_torch.backprop import (
    GAN,
    STYLE_GAN_SOFTPLUS_INVERSE_R1_GP,
    STYLE_GAN_WGAN_GP,
    state_from_ku,
)
from ku_torch.core import TrainState
from ku_torch.engine_ext import adam
from ku_torch.io import CheckpointManager, restore_train_state, save_train_state
from ku_torch.io.checkpoint import packed, trees_equal
from ku_torch.nn.transformer import Dense
from ku_torch.utils import (
    CheckpointCallback,
    EarlyStopping,
    History,
    LambdaCallback,
    start_profile,
    step_trace,
    stop_profile,
    trace,
)

REL = 1e-5
CPU = "cpu"
K = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the toy GAN (tests/test_torch_gan.py's), in both packages ---------------------


class KuToyGen(fnn.Module):
    @fnn.compact
    def __call__(self, z, deterministic: bool = True):
        h = fnn.relu(fnn.Dense(16)(z))
        return fnn.Dense(8)(h)


class KuToyDisc(fnn.Module):
    @fnn.compact
    def __call__(self, x, deterministic: bool = True):
        h = fnn.relu(fnn.Dense(16)(x))
        return fnn.Dense(1)(h)


class ToyGen(torch.nn.Module):
    def __init__(self, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.Dense_0 = Dense(4, 16, device=CPU, generator=g)
        self.Dense_1 = Dense(16, 8, device=CPU, generator=g)

    def forward(self, z, deterministic: bool = True):
        return self.Dense_1(torch.relu(self.Dense_0(z)))


class ToyDisc(torch.nn.Module):
    def __init__(self, seed=1):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.Dense_0 = Dense(8, 16, device=CPU, generator=g)
        self.Dense_1 = Dense(16, 1, device=CPU, generator=g)

    def forward(self, x, deterministic: bool = True):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def _hps(mode, epochs, batch_step=2):
    return {"composing_mode": mode, "epochs": epochs, "batch_step": batch_step,
            "disc_k_step": K, "r_gamma": 10.0, "wgan_lambda": 10.0, "wgan_target": 1.0,
            "disc_ext_hps": {"lr": 1e-3, "beta_1": 0.0, "beta_2": 0.99},
            "gen_disc_hps": {"lr": 1e-3, "beta_1": 0.0, "beta_2": 0.99}}


def _epoch_batches(epoch, batch_step=2):
    """The batches of one epoch, drawn from the epoch's own seed, so that a
    resumed run reads what the uninterrupted one read."""
    rng = np.random.default_rng(1000 + epoch)
    return [{"x": rng.normal(2.0, 0.5, size=(16, 8)).astype(np.float32),
             "z": rng.normal(size=(16, 4)).astype(np.float32)}
            for _ in range(batch_step * (K + 1))]


def _data(first_epoch=0, epochs=8, batch_step=2):
    for e in range(first_epoch, epochs):
        yield from _epoch_batches(e, batch_step)


def _port(mode, epochs, seed=0, batch_step=2):
    engine = GAN({"hps": _hps(mode, epochs, batch_step)}, ToyGen(seed), ToyDisc(seed + 1))
    return engine.compose_gan_with_mode().compile()


def _ku_state(state):
    out = jax.tree.map(np.asarray, {k: v for k, v in state.items() if not k.endswith("_opt")})
    for side in ("gen_opt", "disc_opt"):
        adam_state = state[side][0]
        out[side] = jax.tree.map(np.asarray, {"count": adam_state.count, "mu": adam_state.mu,
                                              "nu": adam_state.nu})
    return out


def _recorder(cls, log):
    return cls(on_train_begin=lambda e: log.append(("begin",)),
               on_train_batch_end=lambda e, s, logs: log.append(("batch", s)),
               on_epoch_end=lambda e, ep, logs: log.append(("epoch", ep)),
               on_train_end=lambda e, h: log.append(("end", len(h["gen_disc_loss"]))))


@functools.lru_cache(maxsize=None)
def _ku_fit(epochs, patience):
    engine = KuGAN({"hps": _hps(STYLE_GAN_SOFTPLUS_INVERSE_R1_GP, epochs)}, KuToyGen(),
                   KuToyDisc()).compose_gan_with_mode().compile()
    engine.init_state(jax.tree.map(jnp.asarray, _epoch_batches(0)[0]), seed=0)
    start = _ku_state(engine.state)
    history, log = KuHistory(), []
    callbacks = [history, _recorder(KuLambdaCallback, log)]
    if patience is not None:
        callbacks.append(KuEarlyStopping("gen_disc_loss", patience=patience, min_delta=1e9))
    engine.fit_generator(_data(epochs=epochs), verbose=0, callbacks=callbacks)
    return start, history.epochs, history.history, log


@pytest.mark.parametrize("patience", [None, 1], ids=["history", "early_stopping"])
def test_callbacks_match_ku(patience):
    epochs = 3
    start, want_epochs, want_hist, want_log = _ku_fit(epochs, patience)
    engine = _port(STYLE_GAN_SOFTPLUS_INVERSE_R1_GP, epochs)
    engine.init_state()
    state_from_ku(engine, start)
    history, log = History(), []
    callbacks = [history, _recorder(LambdaCallback, log)]
    if patience is not None:
        callbacks.append(EarlyStopping("gen_disc_loss", patience=patience, min_delta=1e9))
    engine.fit_generator(_data(epochs=epochs), verbose=0, callbacks=callbacks)
    assert history.epochs == want_epochs == (list(range(epochs)) if patience is None
                                             else [0, 1])
    assert log == want_log
    assert log.count(("begin",)) == 1 and sum(1 for c in log if c[0] == "batch") == (
        2 * len(want_epochs))
    assert history.history.keys() == want_hist.keys()
    for key, want in want_hist.items():
        np.testing.assert_allclose(history.history[key], want, rtol=REL, atol=0, err_msg=key)


# -- resume ----------------------------------------------------------------------


def _state_of(engine):
    return packed(engine.checkpoint_tree())


def test_resume_equals_uninterrupted_run(tmp_path):
    """WGAN-GP draws its interpolation weights from the state's generator, so
    the resumed run matches only if the generator's state came back too."""
    epochs = 4
    full = _port(STYLE_GAN_WGAN_GP, epochs)
    full.fit_generator(_data(epochs=epochs), verbose=0)

    first = _port(STYLE_GAN_WGAN_GP, 2)
    first.fit_generator(_data(epochs=2), verbose=0,
                        callbacks=[CheckpointCallback(str(tmp_path), max_to_keep=2)])
    # A fresh engine, other initial parameters: everything comes from the
    # checkpoint.
    resumed = _port(STYLE_GAN_WGAN_GP, epochs, seed=7)
    ckpt = CheckpointCallback(str(tmp_path), max_to_keep=2)
    history, log = History(), []
    resumed.fit_generator(_data(first_epoch=2, epochs=epochs), verbose=0,
                          callbacks=[ckpt, history, _recorder(LambdaCallback, log)],
                          initial_epoch="auto")
    assert history.epochs == [2, 3] and ckpt.mgr.all_steps() == [2, 3]
    assert trees_equal(_state_of(resumed), _state_of(full))
    assert resumed.state["gen"].step == full.state["gen"].step == epochs * 2
    assert resumed.state["disc"].step == epochs * 2 * K
    # The checkpoint holds what the engine held at its epoch's end.
    assert trees_equal(ckpt.mgr.read(3), _state_of(full))


def _factory(calls, batch_step=1):
    def factory(stage, g_depth, d_depth):
        calls.append(stage)
        rng = np.random.default_rng(50 + stage)
        batches = [{"x": rng.normal(2.0, 0.5, size=(8, 8)).astype(np.float32),
                    "z": rng.normal(size=(8, 4)).astype(np.float32)}
                   for _ in range(batch_step * (K + 1))]
        return ToyGen(10 + stage), ToyDisc(20 + stage), iter(batches)

    return factory


def test_progressive_resume_restarts_after_last_complete_stage(tmp_path):
    stages = 3
    full, full_calls = _port(STYLE_GAN_SOFTPLUS_INVERSE_R1_GP, stages, batch_step=1), []
    full.fit_generator_progressively(_factory(full_calls), verbose=0, seed=5)
    assert full_calls == [0, 1, 2]

    cut, calls = _port(STYLE_GAN_SOFTPLUS_INVERSE_R1_GP, stages, batch_step=1), []
    ckpt = CheckpointCallback(str(tmp_path), max_to_keep=5)
    factory = _factory(calls)

    def stop_after_stage_1(engine, epoch, logs):
        if epoch == 1:
            raise KeyboardInterrupt  # the process dies after stage 1's checkpoint

    with pytest.raises(KeyboardInterrupt):
        cut.fit_generator_progressively(
            factory, verbose=0, seed=5,
            callbacks=[ckpt, LambdaCallback(on_epoch_end=stop_after_stage_1)])
    assert ckpt.mgr.all_steps() == [0, 1]
    # Stage 2's save was under way when the process died.
    os.makedirs(tmp_path / ".tmp-2-1234-dead")
    (tmp_path / ".tmp-2-1234-dead" / "state.pt").write_bytes(b"\x80half")

    resumed, calls = _port(STYLE_GAN_SOFTPLUS_INVERSE_R1_GP, stages, batch_step=1), []
    hist = resumed.fit_generator_progressively(
        _factory(calls), verbose=0, seed=5, initial_epoch="auto",
        callbacks=[CheckpointCallback(str(tmp_path), max_to_keep=5)])
    assert calls == [1, 2]  # stage 1 rebuilt to restore into, then stage 2 trained
    assert len(hist) == 1 and not os.path.exists(tmp_path / ".tmp-2-1234-dead")
    assert trees_equal(_state_of(resumed), _state_of(full))


# -- the manager -------------------------------------------------------------------


# A TrainState over a tiny module after ``steps`` Adam steps on gradients
# drawn from its generator, and a buffer; the SIGKILL test's saver runs the
# same source in its own process.
_STATE_SRC = textwrap.dedent("""
    import torch
    from ku_torch.core import TrainState
    from ku_torch.engine_ext import adam

    def small_state(seed=0, steps=0):
        torch.manual_seed(seed)
        module = torch.nn.Linear(5, 3)
        module.register_buffer("stat", torch.zeros(3))
        draws = torch.Generator().manual_seed(seed)
        st = TrainState.create(module.parameters(), adam(1e-2), draws)
        for _ in range(steps):
            st.apply_gradients([torch.randn(p.shape, generator=draws) for p in st.params])
            module.stat += 1.0
        return {"train": st, "stat": module.stat}
""")
_NS = {}
exec(_STATE_SRC, _NS)
_small_state = _NS["small_state"]


def test_debris_is_ignored_and_swept_only_on_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None and mgr.restore() is None
    mgr.save(0, _small_state(steps=1))
    os.makedirs(tmp_path / ".tmp-1-99-abc")
    (tmp_path / ".tmp-1-99-abc" / "state.pt").write_bytes(b"partial")
    os.makedirs(tmp_path / "5")  # a step directory without its file
    assert mgr.latest_step() == 0 and mgr.all_steps() == [0]
    CheckpointManager(str(tmp_path))  # opening sweeps nothing
    mgr.save(1, _small_state(steps=2))
    assert os.path.exists(tmp_path / ".tmp-1-99-abc") and mgr.latest_step() == 1
    target = _small_state(seed=3)
    mgr.restore(0, template=target)
    assert not os.path.exists(tmp_path / ".tmp-1-99-abc")
    assert trees_equal(packed(target), packed(_small_state(steps=1)))


def test_max_to_keep_and_intervals(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "a"), max_to_keep=2)
    for s in range(5):
        assert mgr.save(s, {"s": torch.tensor(s)})
    assert mgr.all_steps() == [3, 4]
    assert not mgr.save(4, {"s": torch.tensor(9)}) and not mgr.save(2, {})
    assert mgr.save(4, {"s": torch.tensor(9)}, force=True)
    assert int(mgr.read()["s"]) == 9 and mgr.all_steps() == [3, 4]
    every = CheckpointManager(str(tmp_path / "b"), max_to_keep=None, save_interval_steps=2)
    saved = [s for s in range(6) if every.save(s, {"s": torch.tensor(s)})]
    assert saved == [0, 2, 4] == every.all_steps()
    save_train_state(str(tmp_path / "c"), {"s": torch.tensor(3)}, step=7)
    assert int(restore_train_state(str(tmp_path / "c"))["s"]) == 3
    assert not [e for e in os.listdir(tmp_path / "a") if not e.isdigit()]


_SAVER = _STATE_SRC + textwrap.dedent("""
    from ku_torch.io import CheckpointManager

    mgr = CheckpointManager(PATH, max_to_keep=3)
    state = small_state()
    big = torch.zeros(1 << 21)
    for step in range(1, 10000):
        state["train"].apply_gradients(
            [torch.randn(p.shape, generator=state["train"].generator)
             for p in state["train"].params])
        state["stat"] += 1.0
        big.fill_(step)
        mgr.save(step, {"state": state, "big": big})
        print(step, flush=True)
""")


def test_sigkill_mid_save_leaves_the_last_complete_step(tmp_path):
    path = str(tmp_path / "ckpt")
    script = f"import sys\nsys.path.insert(0, {REPO!r})\nPATH = {path!r}\n" + _SAVER
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                            text=True, env=env)
    try:
        printed = [int(proc.stdout.readline()) for _ in range(3)]
        time.sleep(float(np.random.default_rng().uniform(0.0, 0.05)))
        proc.send_signal(signal.SIGKILL)
    finally:
        proc.kill()
        proc.wait()
    mgr = CheckpointManager(path)
    step = mgr.latest_step()
    assert step >= printed[-1]
    target = {"state": _small_state(seed=4), "big": torch.ones(1 << 21)}
    mgr.restore(template=target)
    assert [e for e in os.listdir(path) if not e.isdigit()] == []
    assert torch.equal(target["big"], torch.full((1 << 21,), float(step)))
    want = _small_state(steps=step)
    assert trees_equal(packed(target["state"]), packed(want))
    assert target["state"]["train"].step == step


# -- tracing ---------------------------------------------------------------------


def test_trace_names_reach_the_profiler(tmp_path):
    x = torch.ones(8, 8)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace("ku_region", phase="fit"):
            x = x @ x
        for step in range(2):
            with step_trace("ku_train_step", step):
                x = x @ x
    names = {e.key for e in prof.key_averages()}
    assert {"ku_region", "ku_train_step"} <= names
    assert [e.count for e in prof.key_averages() if e.key == "ku_train_step"] == [2]

    start_profile(str(tmp_path))
    with trace("ku_captured"):
        x = x @ x
    path = stop_profile()
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "ku_captured" for e in events)
    assert stop_profile() is None
