"""Checkpoint / resume of whole train states (port of ``ku/io/checkpoint.py``).

``ku`` writes orbax checkpoints of its train state (parameters, optimizer
state, key, step). Here a step is one ``torch.save`` file, ``<step>/state.pt``
under the manager's directory, holding the tree given to :meth:`save` with
every tensor on the CPU:

- a :class:`~ku_torch.core.state.TrainState` as its parameters, its
  optimizer's ``state_dict()`` (Adam's moments and step counts), its
  generator's state and its step;
- tensors (a module's buffers, say), ``torch.Generator``s, optimizers,
  numbers, strings and None as themselves; dicts, lists and tuples of
  these. Files are read back with ``torch.load(weights_only=True)``, which
  runs no code from the file.

A save writes into a temporary directory beside the steps
(``.tmp-<step>-...``) and publishes it with one ``os.replace``: a process
killed mid-save leaves only the temporary directory, which
:meth:`CheckpointManager.latest_step` never reads, so the last complete step
stays the resume point. Temporary directories are swept on restore, never
when a manager opens a directory (another process may be saving into it).
Saving is synchronous.

``restore(step, template)`` writes the step back *into* ``template``, a tree
of the same structure whose tensors, train states and generators are the
live ones (a module's parameters and buffers, its optimizer), bit for bit,
and returns it; without a template it returns the tree as saved, tensors on
the CPU.
"""

from __future__ import annotations

import os
import shutil
import uuid
from typing import Any, List, Mapping, Optional

import numpy as np
import torch

from ku_torch.core.state import TrainState

_FILE = "state.pt"
_TMP = ".tmp-"


def packed(tree):
    """``tree`` as :meth:`CheckpointManager.save` writes it, tensors copied
    to the CPU (to compare a live state with a saved one)."""
    if isinstance(tree, TrainState):
        return {"__train_state__": True,
                "params": [p.detach().cpu().clone() for p in tree.params],
                "optimizer": (packed(tree.optimizer.state_dict())
                              if tree.optimizer is not None else None),
                "generator": tree.generator.get_state() if tree.generator is not None else None,
                "step": tree.step}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, torch.Generator):
        return {"__generator__": tree.get_state()}
    if isinstance(tree, torch.optim.Optimizer):
        return packed(tree.state_dict())
    if isinstance(tree, Mapping):
        return {k: packed(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(packed(v) for v in tree)
    return tree


def _unpack_into(template, saved):
    """Write ``saved`` into ``template`` in place where it holds live objects;
    returns the restored tree."""
    if isinstance(template, TrainState):
        with torch.no_grad():
            for p, v in zip(template.params, saved["params"], strict=True):
                p.copy_(v)
        if template.optimizer is not None and saved["optimizer"] is not None:
            template.optimizer.load_state_dict(saved["optimizer"])
        if template.generator is not None and saved["generator"] is not None:
            template.generator.set_state(saved["generator"])
        template.step = int(saved["step"])
        return template
    if isinstance(template, torch.Tensor):
        with torch.no_grad():
            return template.copy_(saved)
    if isinstance(template, torch.Generator):
        template.set_state(saved["__generator__"])
        return template
    if isinstance(template, torch.optim.Optimizer):
        template.load_state_dict(saved)
        return template
    if isinstance(template, Mapping):
        if set(template) != set(saved):
            raise ValueError(f"checkpoint keys {sorted(saved)} differ from the "
                             f"template's {sorted(template)}")
        for k in template:
            template[k] = _unpack_into(template[k], saved[k])
        return template
    if isinstance(template, (list, tuple)):
        return type(template)(_unpack_into(t, s) for t, s in zip(template, saved, strict=True))
    return saved


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    """Steps of a train state under ``directory``, the newest
    ``max_to_keep`` kept (None keeps all), a step saved when it is a
    multiple of ``save_interval_steps`` and past the latest (``force``
    saves any step, replacing one that exists)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, int(save_interval_steps))
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        """The complete steps, oldest first."""
        return sorted(int(e) for e in os.listdir(self.directory)
                      if e.isdigit() and os.path.isfile(os.path.join(self.directory, e, _FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        step = int(step)
        if not force:
            latest = self.latest_step()
            if step % self.save_interval_steps or (latest is not None and step <= latest):
                return False
        tmp = os.path.join(self.directory, f"{_TMP}{step}-{os.getpid()}-{uuid.uuid4().hex}")
        os.makedirs(tmp)
        path = os.path.join(tmp, _FILE)
        with open(path, "wb") as f:
            torch.save(packed(state), f)
            f.flush()
            os.fsync(f.fileno())
        target = self._step_dir(step)
        if os.path.exists(target):
            self._discard(target)
        os.replace(tmp, target)
        _fsync_dir(self.directory)
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                self._discard(self._step_dir(old))
        return True

    def _discard(self, step_dir: str):
        """Take a step out of view with one rename, then delete it."""
        tmp = os.path.join(self.directory, f"{_TMP}gone-{uuid.uuid4().hex}")
        os.replace(step_dir, tmp)
        shutil.rmtree(tmp, ignore_errors=True)

    def sweep(self) -> List[str]:
        """Delete the temporary directories that killed saves left; returns
        their names."""
        gone = [e for e in os.listdir(self.directory) if e.startswith(_TMP)]
        for e in gone:
            shutil.rmtree(os.path.join(self.directory, e), ignore_errors=True)
        return gone

    def read(self, step: Optional[int] = None):
        """The tree saved at ``step`` (the latest when None) as saved,
        tensors on the CPU; None when there is no complete step."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            return None
        return torch.load(os.path.join(self._step_dir(step), _FILE), map_location="cpu",
                          weights_only=True)

    def restore(self, step: Optional[int] = None, template: Any = None):
        """Sweep leftover temporary directories, then restore ``step`` (the
        latest when None) into ``template`` (see the module docstring); None
        when there is no complete step."""
        self.sweep()
        saved = self.read(step)
        if saved is None or template is None:
            return saved
        return _unpack_into(template, saved)

    def wait_until_finished(self):
        """Saves are synchronous: each has finished when :meth:`save`
        returns, so there is nothing to wait for."""

    def close(self):
        """Nothing is held open between saves."""


def save_train_state(path: str, state: Any, step: int = 0, max_to_keep: Optional[int] = 10):
    """One forced save of ``state`` at ``step``; ``max_to_keep=None`` keeps
    every step."""
    CheckpointManager(path, max_to_keep=max_to_keep).save(step, state, force=True)


def restore_train_state(path: str, template: Any = None, step: Optional[int] = None):
    return CheckpointManager(path).restore(step, template=template)


def trees_equal(a, b) -> bool:
    """Two saved trees equal bit for bit (tensors by ``torch.equal``)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b))
    if isinstance(a, Mapping) and isinstance(b, Mapping):
        return a.keys() == b.keys() and all(trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return a == b
