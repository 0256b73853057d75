"""Training callbacks: history, early stopping, checkpointing (port of
``ku/utils/callbacks.py``).

The protocol that ``ku_torch.backprop.AbstractGAN.fit_generator`` calls:
``on_train_begin(engine)``, ``on_train_batch_end(engine, step, logs)`` after
each step, ``on_epoch_end(engine, epoch, logs)``, ``on_train_end(engine,
history)``; a callback with ``maybe_restore(engine)`` serves
``initial_epoch="auto"``. :class:`CheckpointCallback` saves the engine's
whole train state through :class:`ku_torch.io.CheckpointManager`:
parameters, Adam moments, steps, the draws' generator state, and the
modules' buffers (an engine's ``checkpoint_tree()``, where it has one, else
its ``state``).
"""

from __future__ import annotations

from typing import Callable, Optional


class Callback:
    def on_train_begin(self, engine):
        pass

    def on_train_batch_end(self, engine, step: int, logs: dict):
        """After each logical step, ``steps_per_call`` fusion or not."""

    def on_epoch_end(self, engine, epoch: int, logs: dict):
        pass

    def on_train_end(self, engine, history: dict):
        pass


class History(Callback):
    """The logs of each epoch (Keras' History)."""

    def __init__(self):
        self.epochs = []
        self.history = {}

    def on_epoch_end(self, engine, epoch, logs):
        self.epochs.append(epoch)
        for k, v in logs.items():
            self.history.setdefault(k, []).append(v)


class EarlyStopping(Callback):
    """Sets ``engine.stop_training`` once ``monitor`` has not improved by
    more than ``min_delta`` for ``patience`` epochs."""

    def __init__(self, monitor: str = "gen_disc_loss", patience: int = 3,
                 min_delta: float = 0.0, mode: str = "min"):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.sign = 1.0 if mode == "min" else -1.0
        self.best = float("inf")
        self.wait = 0

    def on_epoch_end(self, engine, epoch, logs):
        current = self.sign * logs.get(self.monitor, float("inf"))
        if current < self.best - self.min_delta:
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                engine.stop_training = True


def _checkpoint_tree(engine):
    tree = getattr(engine, "checkpoint_tree", None)
    return tree() if callable(tree) else engine.state


class CheckpointCallback(Callback):
    """The engine's whole train state saved every ``every`` epochs under the
    epoch's index, the newest ``max_to_keep`` kept; :meth:`maybe_restore`
    resumes from the latest."""

    def __init__(self, directory: str, every: int = 1, max_to_keep: int = 3):
        from ku_torch.io import CheckpointManager

        self.every = every
        self.mgr = CheckpointManager(directory, max_to_keep=max_to_keep)

    def maybe_restore(self, engine) -> Optional[int]:
        """Restore the latest checkpoint into the engine, in place; returns
        its epoch, or None when there is none."""
        step = self.mgr.latest_step()
        if step is None:
            return None
        self.mgr.restore(step, template=_checkpoint_tree(engine))
        return step

    def on_epoch_end(self, engine, epoch, logs):
        if (epoch + 1) % self.every == 0:
            self.mgr.save(epoch, _checkpoint_tree(engine))

    def on_train_end(self, engine, history):
        self.mgr.wait_until_finished()


class LambdaCallback(Callback):
    def __init__(self, on_epoch_end: Optional[Callable] = None,
                 on_train_begin: Optional[Callable] = None,
                 on_train_end: Optional[Callable] = None,
                 on_train_batch_end: Optional[Callable] = None):
        self._epoch_end = on_epoch_end
        self._train_begin = on_train_begin
        self._train_end = on_train_end
        self._batch_end = on_train_batch_end

    def on_train_begin(self, engine):
        if self._train_begin:
            self._train_begin(engine)

    def on_train_batch_end(self, engine, step, logs):
        if self._batch_end:
            self._batch_end(engine, step, logs)

    def on_epoch_end(self, engine, epoch, logs):
        if self._epoch_end:
            self._epoch_end(engine, epoch, logs)

    def on_train_end(self, engine, history):
        if self._train_end:
            self._train_end(engine, history)
