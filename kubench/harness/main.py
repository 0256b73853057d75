"""One run of one cell: set-up, the measured window, the check, the result.

``python3 kubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. In order:

1. finds the cell's files by name (:mod:`kubench.harness.spec`) and the
   card (no card, or fewer than the cell asks for: exit 3, no result);
2. has the cell's driver make its inputs on the card from the seed (with
   the mix's generator), load (in a checkout's first run, build) the
   program's kernels into ``ku_torch/_build``, and warm up with one job of
   the cell's shape; all of that is ``setup_s``;
3. runs jobs back to back, each ending in ``torch.cuda.synchronize()``,
   until ``--seconds`` have passed, and ends the window with the last job;
   with ``--trace 1`` under ``torch.profiler``, written to
   ``kubench/_run/<cell>.trace.json`` and read by the per-layer readers;
4. reads the peak memory, has the driver check the program's counters
   (launches and their routes), then has it repeat a sample of the jobs,
   drawn from the seed, in the plain reference and compare
   (:mod:`kubench.harness.compare`);
5. prints the counters, the check's diagnostics, the shares beside the
   card's name and power limit, and then, last, the numbers compared on
   standard error and the result's JSON line on standard output.

A process that holds ``jax``, ``jaxlib``, ``flax`` or ``ku`` once the
window has closed prints no result and exits 4.
"""

from __future__ import annotations

import argparse
from contextlib import nullcontext
import gc
import json
import random
import sys
import time

from kubench.harness import card, compare, spec, trace as tr, traffic as tf
from kubench.harness.jobs import Run

FORBIDDEN = ("jax", "jaxlib", "flax", "ku")
SAMPLED = 2       # jobs of a run repeated by the reference
EXIT_NO_CARD, EXIT_FORBIDDEN, EXIT_SPEC = 3, 4, 5


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole: ``ku_torch`` is not ``ku``."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def parse(argv):
    p = argparse.ArgumentParser(prog="kubench/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(name: str, seed: int, seconds: float, trace: bool, t0: float,
             device=None, traffic=None, small=False, root=spec.ROOT) -> dict:
    """One run; returns the result's dict, or raises. ``device``,
    ``traffic``, ``small`` and ``root`` are for the benchmark's own tests:
    they skip the look for a card, replace the cell's mix, run the cell at
    its ``"small"`` size and find it in another checkout."""
    cell = spec.load_cell(name, root=root, small=small)
    if traffic is not None:
        cell.traffic = traffic
    import torch

    marks = {"imports": time.perf_counter() - t0}
    dev = device if device is not None else card.require(torch, cell.chips)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    driver = cell.driver().Driver(torch, cell.config, cell.traffic, seed, dev, bool(trace))
    sync()
    marks["inputs"] = time.perf_counter() - t0
    driver.job(tf.job_seed(seed, -1))
    sync()
    driver.mark()
    setup_s = time.perf_counter() - t0
    marks["warm_up"] = setup_s
    # Where set-up went, in seconds since the process started: torch
    # imported, the card's context and the driver's inputs made, the first
    # job (in a checkout's first run, the build of the kernels) done.
    print(json.dumps({"setup_s_at": marks}), file=sys.stderr, flush=True)

    span = torch.profiler.record_function
    prof = tr.start(torch) if trace else None
    pick = random.Random(tf.mix(seed, "sample"))
    jobs, sample = [], []
    start = time.perf_counter()
    with (span(tr.WINDOW) if trace else nullcontext()):
        while True:
            t = time.perf_counter()
            with (span(tr.JOB) if trace else nullcontext()):
                job = driver.job(tf.job_seed(seed, len(jobs)))
                sync()
            job.wall_s = time.perf_counter() - t
            # Reservoir sampling: each job is kept for the check with equal
            # chance, whatever the window's length.
            if len(sample) < SAMPLED:
                sample.append(job)
            else:
                slot = pick.randrange(len(jobs) + 1)
                if slot < SAMPLED:
                    sample[slot].answer = None
                    sample[slot] = job
                else:
                    job.answer = None
            jobs.append(job)
            if time.perf_counter() - start >= seconds:
                break
    window_s = time.perf_counter() - start

    trace_data = None
    if trace:
        path = spec.BENCH / "_run" / f"{name}.trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        tr.stop(prof, path)
        trace_data = tr.read(path)
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    # The counters, then the program's outputs that are not sampled are
    # gone and the reference runs.
    counters, off_plan = driver.summary(jobs)
    failed = sum(not all(bool(s.isfinite().all()) for s in job.scores) for job in jobs)
    print(json.dumps({"counters": counters}), flush=True)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    values = {}
    for job in sample:
        found, info = driver.check(job)
        print(json.dumps({"check_info": {"job_seed": job.seed, **info}}), file=sys.stderr)
        for key, value in found.items():
            values[key] = max(values.get(key, 0.0), value)
    values["failed_jobs"] = failed
    values["off_plan"] = off_plan
    limits = dict(cell.config["limits"], failed_jobs=0, off_plan=0)
    correct, checks = compare.verdict(values, limits)

    name_line = torch.cuda.get_device_name(dev) if on_card else "cpu"
    power = card.power_line() if on_card else "cpu"
    run = Run(name, jobs, setup_s, window_s, card.peaks(name_line) if on_card else None,
              power, trace_data)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            if m["unit"] == "%":
                print(f"{m['name']} {value:.6g} % ({power}; peaks {run.peaks['match']}: "
                      f"{peak_rates(run)}, {run.peaks['bytes_per_s']:g} B/s)"
                      if on_card else f"{m['name']} {value:.6g} %", file=sys.stderr)
    for msg in run.notes:
        print(msg, file=sys.stderr)

    device = {"platform": "gpu" if on_card else "cpu", "kind": name_line, "count": cell.chips,
              "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(jobs), "failed": failed,
              "metrics": metrics, "device": device}
    if trace_data is not None:
        device["busy_s"] = trace_data.busy_s
        device["window_s"] = trace_data.window_s
        result["breakdown"] = {"device_ops": trace_data.device_ops(),
                               "idle_gaps": trace_data.idle_gaps()}
    result["card"] = power
    result["checks"] = checks
    return result


def peak_rates(run) -> str:
    """The dense peaks the window's jobs are counted at, as
    ``tf32 4.95e+14 FLOP/s``."""
    return ", ".join(f"{p} {run.peaks[p]:g} FLOP/s" if p in run.peaks else f"{p} not in peaks.json"
                     for p in sorted(run.flops_by_peak()))


def main(argv, t0: float) -> int:
    args = parse(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0)
    except card.NoCard as e:
        print(f"kubench: {e}", file=sys.stderr)
        return EXIT_NO_CARD
    except spec.SpecError as e:
        print(f"kubench: {e}", file=sys.stderr)
        return EXIT_SPEC
    found = forbidden_modules()
    if found:
        print(f"kubench: the process holds {', '.join(found)}: no result", file=sys.stderr)
        return EXIT_FORBIDDEN
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
