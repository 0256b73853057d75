"""Profiling and tracing (port of ``ku/utils/trace.py``).

- :func:`trace`: a named region in the profile, ``torch.profiler
  .record_function`` (``ku``: ``jax.profiler.TraceAnnotation``), while a
  torch profiler runs; otherwise one shared context that does nothing, so
  spans on the training path cost a function call when nobody traces.
- :func:`step_trace`: the same, carrying the step number in its arguments
  (``ku``: ``StepTraceAnnotation``).
- :func:`start_profile` / :func:`stop_profile`: one ``torch.profiler
  .profile`` capture, the host and (when a card is present) the device,
  written as a Chrome trace into ``logdir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

_ACTIVE = {}


_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def trace(name: str = "TraceContext", **kwargs):
    """A context annotating a region; ``kwargs`` go into the event's
    arguments. With no profiler running it is a shared null context, and no
    event or argument string is made. The Chrome trace keeps the name but
    not the arguments, so an identifier the trace must carry belongs in the
    name."""
    if not _profiling():
        return _OFF
    args = ", ".join(f"{k}={v}" for k, v in kwargs.items()) or None
    return torch.profiler.record_function(name, args)


def step_trace(name: str, step_num: int):
    return trace(name, step_num=int(step_num))


def start_profile(logdir: str):
    """Begin a capture whose trace :func:`stop_profile` writes into
    ``logdir``."""
    if _ACTIVE:
        raise RuntimeError("a profile is already being captured")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities, record_shapes=False)
    prof.start()
    _ACTIVE.update(prof=prof, logdir=logdir)


def stop_profile() -> Optional[str]:
    """End the capture; returns the Chrome trace's path."""
    if not _ACTIVE:
        return None
    prof, logdir = _ACTIVE.pop("prof"), _ACTIVE.pop("logdir")
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path
