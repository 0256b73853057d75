"""The traced run: ``torch.profiler`` over the measured window, written as a
Chrome trace, and what the metric readers take from it.

Spans come from the benchmark's own files, around its calls into the
program: ``kubench.window`` around the window, ``kubench.job`` around each
job (the call and the synchronise after it), and the drivers' spans around
each layer. Device operations are the trace's kernels, copies and sets.
Times in the trace are microseconds on one clock for host and device.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW, JOB = "kubench.window", "kubench.job"


def start(torch):
    """A running profiler of the host and the card."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop(prof, path) -> None:
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(str(path))


def merge(intervals):
    """Sorted, disjoint (start, end) covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(merged, lo: float, hi: float) -> float:
    """Length of [lo, hi] that the merged intervals cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


@dataclass
class Trace:
    """What a traced window holds, in seconds unless named."""
    window: tuple                      # (start us, end us)
    device: list                       # (name, start us, end us), by start
    host: list = field(default_factory=list)      # (name, start us, end us)
    jobs: list = field(default_factory=list)      # (start us, end us) of each job span

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_merged(self):
        lo, hi = self.window
        return merge((max(s, lo), min(e, hi)) for _, s, e in self.device if e > lo and s < hi)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_merged()) / 1e6

    def kernels(self, pattern) -> list:
        """(name, start us, end us) of the kernels that start in the window
        and whose name ``pattern`` (a compiled regex) finds, by start. By
        start, not by end: the device's clock is mapped onto the host's,
        and the last job's kernel can end a few microseconds past the
        window's close on that scale though the window waited for it."""
        lo, hi = self.window
        return [d for d in self.device if pattern.search(d[0]) and lo <= d[1] <= hi]

    def device_ops(self, top: int = 10) -> list:
        totals = {}
        for name, s, e in self.device:
            totals[name] = totals.get(name, 0.0) + (e - s) / 1e6
        return sorted(([n, t] for n, t in totals.items()), key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest stretches of the window with no device operation,
        each named by the innermost host event running at its middle."""
        lo, hi = self.window
        edges = [lo] + [x for s, e in self.busy_merged() for x in (s, e)] + [hi]
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, reverse=True)[:top]
        starts = [h[1] for h in self.host]
        out = []
        for length, s, e in gaps:
            mid = (s + e) / 2
            name = "no host event"
            for h in reversed(self.host[:bisect.bisect_right(starts, mid)]):
                if h[2] >= mid:
                    name = h[0]
                    break
            out.append([name, length / 1e6])
        return out


def read(path) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    windows = [e for e in spans if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not windows:
        raise RuntimeError(f"the trace {path} holds no {WINDOW} span")
    w = max(windows, key=lambda e: e["dur"])
    window = (float(w["ts"]), float(w["ts"]) + float(w["dur"]))
    by_start = lambda x: x[1]  # noqa: E731
    device = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in spans if e.get("cat") in DEVICE_CATS), key=by_start)
    host = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in spans if e.get("cat") in HOST_CATS and e.get("name") != WINDOW),
                  key=by_start)
    jobs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in spans if e.get("name") == JOB and e.get("cat") == "user_annotation")
    return Trace(window, device, host, jobs)
