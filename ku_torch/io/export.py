"""Model export for serving (port of ``ku/io/export.py``): ``ku``
serializes a jitted function to StableHLO with ``jax.export``; here the
function is traced by ``torch.export`` into an ``ExportedProgram`` file
that ``torch.export.load`` runs without the Python model code.

A function whose path launches a hand-written kernel cannot be exported:
the kernels launch through ``ctypes`` on ``data_ptr()``, and
``torch.export`` traces with fake tensors, which have no storage. Such an
export raises ``ku_torch.kernels._build.KernelTraceError`` naming the
kernel's wrapper (the wrappers refuse a tracer's fake tensors); nothing
exports the plain version in its place. On the CPU the port's modules
compute the plain versions, which export.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


class _Fn(torch.nn.Module):
    """``fn`` as a module (a module passed in is exported as it is)."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_fn(fn: Callable, example_args: Sequence, path: str) -> None:
    """Trace ``fn(*example_args)`` with ``torch.export.export`` and save the
    program to ``path``. ``fn``: a module, or a function (what it closes
    over is baked in as constants)."""
    module = fn if isinstance(fn, torch.nn.Module) else _Fn(fn)
    torch.export.save(torch.export.export(module, tuple(example_args)), path)


class _Loaded:
    """An exported program reloaded: ``call(*args)`` runs it."""

    def __init__(self, program):
        self.program = program
        self._module = program.module()

    def call(self, *args):
        return self._module(*args)


def load_exported(path: str) -> _Loaded:
    """Reload a file written by :func:`export_fn`; the result's
    ``.call(*args)`` runs it."""
    return _Loaded(torch.export.load(path))
