"""Readings that set the limits of the comparison that decides ``correct``.

    python3 kubench/calibrate.py --workload <cell> --seeds 11,12,13 [--jobs 2]

For each seed, at the cell's own size, on the card, in one process:

- ``program``: ``--jobs`` jobs of the program as a run makes them, each
  judged against the reference (its lower readings);
- ``control``: ``Driver.control``, the reference itself in the
  program's place at the nearest precision below the one the
  configuration states (for the float32 CD configurations, TF32 off: its
  products in TF32);
- each fault of the driver's ``FAULTS``, planted in the program by the
  driver's ``fault``.

Prints one JSON line a reading, with the verdict of the configuration's
limits on it (``correct``) and the check's diagnostics, then, per number,
the largest program reading and the smallest reading of the control and
of each fault, and per kind how many readings were correct. The
benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":  # run as a script: modules are found from the checkout's root
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from kubench.harness import card, compare, spec, traffic as tf  # noqa: E402


def readings(name: str, seeds, jobs: int, device, out):
    import torch

    cell = spec.load_cell(name)
    driver_module = cell.driver()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    found = []

    def emit(driver, seed, kind, job, t):
        values, info = driver.check(job)
        correct, _ = compare.verdict(values, cell.config["limits"])
        row = {"cell": name, "seed": seed, "kind": kind, "correct": correct, "values": values,
               "info": info, "seconds": round(time.perf_counter() - t, 3)}
        found.append(row)
        print(json.dumps(row), file=out, flush=True)

    for seed in seeds:
        driver = driver_module.Driver(torch, cell.config, cell.traffic, seed, device, False)
        for j in range(jobs):
            t = time.perf_counter()
            job = driver.job(tf.job_seed(seed, j))
            sync()
            emit(driver, seed, "program", job, t)
            del job
        t = time.perf_counter()
        emit(driver, seed, "control", driver.control(tf.job_seed(seed, 0)), t)
        for f in driver_module.FAULTS:
            t = time.perf_counter()
            with driver_module.fault(f):
                job = driver.job(tf.job_seed(seed, 0))
                sync()
            emit(driver, seed, f, job, t)
            del job
        del driver
    return found


def summary(found) -> dict:
    """Per number: the largest program reading (lower) and, per other
    kind, the smallest reading; per kind, its correct readings of all."""
    out = {"correct": {}}
    for row in found:
        c = out["correct"].setdefault(row["kind"], [0, 0])
        c[0] += bool(row["correct"])
        c[1] += 1
        for key, value in row["values"].items():
            s = out.setdefault(key, {})
            if row["kind"] == "program":
                s["lower"] = max(s.get("lower", 0.0), value)
            else:
                s[row["kind"]] = min(s.get(row["kind"], float("inf")), value)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--jobs", type=int, default=2)
    args = p.parse_args(argv)
    import torch

    device = card.require(torch, spec.load_cell(args.workload).chips)
    seeds = [int(s) for s in args.seeds.split(",")]
    found = readings(args.workload, seeds, args.jobs, device, sys.stdout)
    print(json.dumps({"summary": summary(found), "card": card.power_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
