"""What a cell is made of, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix, and each metric. Everything else sits in a file of its own:

- ``<config file>`` (``configs[].file``): the sizes and the training
  settings as run, the ``driver`` that runs them, and the ``limits`` of
  the comparison that decides ``correct``, one for each number that
  ``Driver.check`` returns;
- ``kubench/traffic/<traffic>.json``: the traffic mix, whose ``kind``
  names its generator, ``kubench/generators/<kind>.py``;
- ``kubench/drivers/<driver>.py``: the entry point a job calls; the driver
  makes its inputs with the mix's generator and reads its own settings,
  counters and answers, so the harness knows nothing of what it drives;
- ``kubench/metrics/<metric>.py``: one reader a metric.

A configuration file and a mix may each hold a ``"small"`` object: the
keys that a test on the CPU puts over the file's own to run the cell at a
size the CPU holds. A run never asks for it, and no driver sees the key.

Adding a cell, a mix or a metric adds files and entries; it edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


class SpecError(RuntimeError):
    """A cell, metric or file that ``BENCHMARK.json`` names is missing."""


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no {path}")
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name``, once: a later
    call for the same file returns the same module, as ``import`` does."""
    if not path.is_file():
        raise SpecError(f"no {path}")
    module = sys.modules.get(name)
    if module is not None and module.__file__ == str(path):
        return module
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def find(home: Path, kind: str, name: str):
    """The module ``<home>/<kind>/<name>.py``: imported as
    ``kubench.<kind>.<name>`` from the checkout's own ``kubench/``, loaded
    from its file under another root (a test's cell)."""
    path = home / kind / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no {kind[:-1]} {name!r} in {home / kind}")
    if home == BENCH:
        return importlib.import_module(f"kubench.{kind}.{name}")
    return load_module(path, f"kubench_{kind}_{name}")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    home: Path = BENCH       # where the cell's mix, generator and driver are

    def driver(self):
        """The module ``kubench/drivers/<driver>.py``."""
        return find(self.home, "drivers", self.config["driver"])


def generator(kind: str, home: Path = BENCH):
    """The module ``kubench/generators/<kind>.py``, whose ``make(torch,
    config, traffic, seed, device)`` makes a run's inputs from its seed."""
    return find(home, "generators", kind)


def metric_applies(metric: dict, cell: str, e2e_names) -> bool:
    """A metric with ``workloads`` is read in those cells; one without is
    read in every cell (an end-to-end metric) or in every cell that reports
    the end-to-end metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def preset(data: dict, small: bool) -> dict:
    """``data`` less its ``"small"`` object; with ``small``, that object's
    keys put over the file's own."""
    over = data.pop("small", {})
    return {**data, **over} if small else data


def load_cell(name: str, bench: dict = None, root: Path = ROOT, small: bool = False) -> Cell:
    """The cell ``name`` of the checkout at ``root``; with ``small``, at
    its configuration's and its mix's ``"small"`` size (a CPU test's)."""
    bench = bench or load_benchmark(root)
    home = root / BENCH.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json; one of {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {name!r} names no configuration {w['config']!r}")
    config = preset(json.loads((root / configs[w["config"]]["file"]).read_text()), small)
    traffic_path = home / "traffic" / f"{w['traffic']}.json"
    if not traffic_path.is_file():
        raise SpecError(f"no {traffic_path}")
    traffic = preset(json.loads(traffic_path.read_text()), small)
    e2e = [m for m in bench["end_to_end"] if metric_applies(m, name, ())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if metric_applies(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer, home)


def reader(metric: str):
    """The reader of ``metric``: ``kubench/metrics/<metric>.py``'s ``read``."""
    module = load_module(BENCH / "metrics" / f"{metric}.py",
                         "kubench_metric_" + metric.replace(".", "_"))
    return module.read
