"""The program's own spans in a traced run, and the trace's links from a
device operation to the host call that launched it.

The port names its spans ``ku_torch.<module>.<what>``
(``ku_torch/utils/trace.py``; they exist only while a profiler runs):
``rbm.fit`` around ``rbm.build``, ``rbm.prep`` and the kernel wrapper's
``cd_gibbs.launch``, whose children are ``cd_gibbs.plan``, ``.alloc`` and
``.call`` (the C entry that launches kernel #1); ``rbm.transform``; and
``dbn.layer<i>`` around a stacked layer's fit and transform. A job's spans
are those inside its ``kubench.job`` span. A program without them gives
none, and the readers of these spans then return None.

:func:`kubench.harness.trace.read` keeps no link, so :func:`read_links`
reads the trace file again: a device operation names the host call that
launched it by its ``correlation`` (the CUDA API call) or, where the trace
has no such call, its ``External id`` (the operator around it).

    python3 -m kubench.harness.spans kubench/_run/<cell>.trace.json

prints, for a traced run's file, where the window's device-idle time fell
(by the innermost span around it), the device time launched from inside
each span, and the gap from each CD launch's ``cd_gibbs.call`` span to its
kernel's start. The benchmark's runs never run this.
"""

from __future__ import annotations

import bisect
import json
import re
import statistics
import sys
from dataclasses import dataclass
from pathlib import Path

from kubench.harness import spec
from kubench.harness.trace import DEVICE_CATS, WINDOW, read

PREFIX = "ku_torch."
FIT, TRANSFORM = "ku_torch.rbm.fit", "ku_torch.rbm.transform"
LAUNCH, CALL = "ku_torch.cd_gibbs.launch", "ku_torch.cd_gibbs.call"
LAUNCHERS = ("cuda_runtime", "cuda_driver")
CD_KERNEL = re.compile(r"\bcd_gibbs(_cluster)?_kernel\b")
SYNC = "cudaDeviceSynchronize"


def program(trace, name: str = None) -> list:
    """(name, start us, end us) of the program's spans that start in the
    window, all of them or those called ``name``, by start."""
    lo, hi = trace.window
    return [h for h in trace.host if h[0].startswith(PREFIX)
            and (name is None or h[0] == name) and lo <= h[1] <= hi]


def overlap(a, b) -> float:
    """Length that two sorted, disjoint lists of (start, end) both cover."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(trace) -> list:
    """The window's stretches with no device operation, (start, end), sorted."""
    lo, hi = trace.window
    edges = [lo] + [x for s, e in trace.busy_merged() for x in (s, e)] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def starting_in(spans, items, at=lambda x: x[1]) -> list:
    """For each of ``spans`` (disjoint, by start), the ``items`` whose
    time ``at(item)`` lies in it."""
    items = sorted(items, key=at)
    times = [at(x) for x in items]
    return [items[bisect.bisect_left(times, s):bisect.bisect_right(times, e)]
            for _, s, e in spans]


@dataclass
class Links:
    """A trace file's window and its device operations, each as (name,
    start us, end us, start of the host call that launched it or None)."""
    window: tuple
    device: list


def trace_path(cell: str) -> Path:
    return spec.BENCH / "_run" / f"{cell}.trace.json"


def read_links(path) -> Links:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    w = max(windows, key=lambda e: e["dur"]) if windows else {"ts": 0.0, "dur": 0.0}
    by_corr, by_ext = {}, {}
    for e in events:
        args = e.get("args") or {}
        if e.get("cat") in LAUNCHERS and "correlation" in args:
            by_corr[args["correlation"]] = float(e["ts"])
        elif e.get("cat") in ("cpu_op", "user_annotation") and "External id" in args:
            by_ext[args["External id"]] = float(e["ts"])
    device = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        args = e.get("args") or {}
        at = by_corr.get(args.get("correlation"), by_ext.get(args.get("External id")))
        device.append((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), at))
    device.sort(key=lambda d: d[1])
    return Links((float(w["ts"]), float(w["ts"]) + float(w["dur"])), device)


def run_links(run):
    """The links of the run's own trace file, or None (and a note) where
    the file is not the trace the run read."""
    links = read_links(trace_path(run.cell))
    if links.window != run.trace.window:
        run.note(f"{trace_path(run.cell)} is not this run's trace; no link read")
        return None
    return links


def launched_in(links, spans) -> list:
    """The device operations whose launching call started inside one of
    ``spans`` (disjoint, by start)."""
    linked = [d for d in links.device if d[3] is not None]
    return [d for found in starting_in(spans, linked, at=lambda d: d[3]) for d in found]


def launch_gaps(trace, links) -> dict:
    """Microseconds from the start of each ``cd_gibbs.call`` span to the
    start of the CD kernel it launched: matched through the trace's link
    where it has one, else the i-th kernel to the i-th span."""
    calls = program(trace, CALL)
    if not calls:
        return {"calls": 0, "matched": None}
    kernels = [d for d in links.device if CD_KERNEL.search(d[0])
               and trace.window[0] <= d[1] <= trace.window[1]]
    linked = starting_in(calls, [k for k in kernels if k[3] is not None], at=lambda d: d[3])
    if all(len(found) == 1 for found in linked):
        matched, how = [found[0] for found in linked], "link"
    elif len(kernels) == len(calls):
        matched, how = kernels, "order"
    else:
        return {"calls": len(calls), "kernels": len(kernels), "matched": None}
    gaps = sorted(k[1] - c[1] for k, c in zip(matched, calls))
    return {"calls": len(calls), "kernels": len(kernels), "matched": how, "min_us": gaps[0],
            "median_us": statistics.median(gaps), "negative": sum(g < 0 for g in gaps)}


def idle_by_span(trace) -> dict:
    """The window's device-idle microseconds a job, by the innermost of the
    program's spans, the synchronise and the harness's spans running on
    the host at the time ("none" where none is)."""
    lo, hi = trace.window
    spans = [h for h in trace.host if lo <= h[1] <= hi and h[2] > h[1] and (
        h[0].startswith((PREFIX, "kubench.")) or h[0] == SYNC)]
    marks = sorted([(s, 1, i) for i, (_, s, _) in enumerate(spans)]
                   + [(e, 0, i) for i, (_, _, e) in enumerate(spans)])
    segments, stack, t = [], [], lo
    for x, opening, i in marks:
        if x > t:
            segments.append((t, x, spans[stack[-1]][0] if stack else "none"))
            t = x
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    segments.append((t, hi, "none"))
    out, gaps = {}, idle(trace)
    i = j = 0
    while i < len(segments) and j < len(gaps):
        (s, e, name), (gs, ge) = segments[i], gaps[j]
        if min(e, ge) > max(s, gs):
            out[name] = out.get(name, 0.0) + min(e, ge) - max(s, gs)
        if e < ge:
            i += 1
        else:
            j += 1
    jobs = max(len(trace.jobs), 1)
    return {name: us / jobs for name, us in sorted(out.items(), key=lambda x: -x[1])}


def device_by_span(trace, links) -> dict:
    """Per job, the device milliseconds of the operations launched inside
    the spans of each of the program's span names (a span's children
    included)."""
    mine = program(trace)
    jobs = max(len(trace.jobs), 1)
    return {name: sum(e - s for _, s, e, _ in launched_in(
        links, [h for h in mine if h[0] == name])) / jobs / 1e3
        for name in sorted({h[0] for h in mine})}


def main(paths) -> None:
    for path in paths:
        trace, links = read(path), read_links(path)
        print(json.dumps({"trace": str(path), "jobs": len(trace.jobs),
                          "launch_gaps": launch_gaps(trace, links),
                          "idle_us_a_job": idle_by_span(trace),
                          "device_ms_a_job": device_by_span(trace, links)}))


if __name__ == "__main__":
    main(sys.argv[1:])
