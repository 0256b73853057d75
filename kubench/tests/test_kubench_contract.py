"""A cell of another kind than a CD run goes in with new files and new
entries alone. The toy cell below (bf16 products, a check whose numbers
are its own, a ``"small"`` size in both of its files) is written under a
temporary root beside a BENCHMARK.json that names it, as a later change
would write it under ``kubench/``. It resolves by name, runs through
``main.run_cell`` on the CPU at its small size with ``correct`` true,
passes the per-cell checks of the harness and imports tests, and reads
``mfu`` at the bf16 peak."""

import json
import textwrap
import time

import pytest
import torch

from kubench.harness import card, main, spec, traffic as tf
from kubench.tests.test_kubench_harness import (check_benchmark, check_limits, check_resolves,
                                                traced_run)
from kubench.tests.test_kubench_imports import check_runs_load_neither_jax_nor_ku

CELL = "toy_chain.products"
CPU = torch.device("cpu")

CONFIG = {
    "name": "toy_chain", "driver": "toy_products", "width": 512, "depth": 4,
    "dtype": "bfloat16", "limits": {"chain_gap": 0.05, "finite_share": 0},
    "small": {"width": 48},
}
MIX = {"kind": "toy_normal", "rows": 1024, "small": {"rows": 24},
       "why": "a batch of normal rows through a chain of bf16 products"}

GENERATOR = '''
"""Generator ``toy_normal``: ``rows`` standard normal rows as wide as the
configuration's ``width``, in bf16, from the seed."""

from kubench.harness.traffic import mix


def make(torch, config, traffic, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, "rows"))
    shape = (int(traffic["rows"]), int(config["width"]))
    return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
'''

DRIVER = '''
"""Driver ``toy_products``: a job multiplies the run's rows through
``depth`` bf16 matrices drawn from its seed; the check repeats the chain in
float64 from the same bf16 inputs."""

import contextlib
from pathlib import Path

from kubench.harness import spec
from kubench.harness.jobs import Job
from kubench.harness.traffic import mix

FAULTS = ("answer_altered",)
BROKEN = []


class Driver:
    def __init__(self, torch, config, traffic, seed, device, spans):
        self.torch, self.device = torch, device
        self.width, self.depth = int(config["width"]), int(config["depth"])
        home = Path(__file__).resolve().parent.parent
        self.rows = spec.generator(traffic["kind"], home).make(torch, config, traffic, seed,
                                                               device)

    def weights(self, seed):
        g = self.torch.Generator(device=self.device)
        g.manual_seed(mix(seed, "weights"))
        w = self.torch.randn((self.depth, self.width, self.width), generator=g,
                             device=self.device)
        return (w / self.width ** 0.5).to(self.torch.bfloat16)

    def job(self, seed):
        x = self.rows
        for w in self.weights(seed):
            x = x @ w
        if BROKEN:
            x = -x
        n = self.rows.shape[0]
        return Job(seed=seed, samples=n, flops=2 * n * self.width ** 2 * self.depth,
                   launches=[], scores=[x], answer=x, peak="bf16")

    def mark(self):
        pass

    def summary(self, jobs):
        return {"jobs": len(jobs)}, 0

    def check(self, job):
        want = self.rows.double()
        for w in self.weights(job.seed):
            want = want @ w.double()
        got = job.answer.double()
        gap = float((got - want).abs().max() / want.abs().max())
        return ({"chain_gap": gap, "finite_share": float((~got.isfinite()).double().mean())},
                {"rows": int(got.shape[0])})

    def control(self, seed):
        """The chain with its weights in fp8 (e4m3), the next precision down."""
        x = self.rows
        for w in self.weights(seed):
            x = x @ w.to(self.torch.float8_e4m3fn).to(self.torch.bfloat16)
        return Job(seed=seed, samples=0, flops=0, launches=[], answer=x)


@contextlib.contextmanager
def fault(name):
    BROKEN.append(name)
    try:
        yield
    finally:
        BROKEN.clear()
'''


@pytest.fixture
def root(tmp_path):
    """A checkout's root whose BENCHMARK.json names the toy cell alone, with
    the repository's end-to-end metrics and ``mfu``."""
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "toy_chain", "source": "https://example.org/toy-chain",
                         "file": "kubench/configs/toy_chain.json", "reduced": [],
                         "why": "bf16 products: a job that is not a CD run"}]
    bench["workloads"] = [{"name": CELL, "config": "toy_chain", "traffic": "toy_batches",
                           "chips": 1, "why": "1,024 rows through four bf16 products"}]
    bench["per_layer"] = [dict(m, workloads=[CELL]) for m in bench["per_layer"]
                          if m["name"] == "mfu"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    files = {"configs/toy_chain.json": json.dumps(CONFIG),
             "traffic/toy_batches.json": json.dumps(MIX),
             "generators/toy_normal.py": textwrap.dedent(GENERATOR),
             "drivers/toy_products.py": textwrap.dedent(DRIVER)}
    for name, text in files.items():
        path = tmp_path / "kubench" / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return tmp_path


def test_the_toy_cell_resolves_by_name(root):
    bench = spec.load_benchmark(root)
    check_benchmark(bench)
    c = spec.load_cell(CELL, bench, root)
    assert c.home == root / "kubench" and c.config["width"] == 512 and c.traffic["rows"] == 1024
    assert "small" not in c.config and "small" not in c.traffic
    s = spec.load_cell(CELL, bench, root, small=True)
    assert (s.config["width"], s.traffic["rows"]) == (48, 24)
    assert [m["name"] for m in c.per_layer] == ["mfu"]
    check_resolves(bench, CELL, root)
    check_limits(bench, CELL, root)


def test_the_toy_cell_runs_correct_at_its_small_size(root):
    result = main.run_cell(CELL, 2**31 + 21, 0.05, False, time.perf_counter(), device=CPU,
                           small=True, root=root)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"chain_gap", "finite_share", "failed_jobs", "off_plan"}
    assert set(result["metrics"]) == {"samples_per_s", "job_ms.p95", "setup_s"}
    driver = spec.load_cell(CELL, root=root).driver()
    with driver.fault("answer_altered"):
        result = main.run_cell(CELL, 2**31 + 21, 0.05, False, time.perf_counter(), device=CPU,
                               small=True, root=root)
    assert not result["correct"]


def test_the_toy_cell_loads_neither_jax_nor_ku(root):
    check_runs_load_neither_jax_nor_ku(root)


def test_the_toy_cells_mfu_reads_at_the_bf16_peak(root, tmp_path):
    c = spec.load_cell(CELL, root=root, small=True)
    driver = c.driver().Driver(torch, c.config, c.traffic, 5, CPU, False)
    jobs = [driver.job(tf.job_seed(5, i)) for i in range(3)]
    assert {job.peak for job in jobs} == {"bf16"}
    run = traced_run(tmp_path, jobs, card.peaks("NVIDIA H100 80GB HBM3"))
    flops = 3 * 2 * 24 * 48 * 48 * 4
    assert spec.reader("mfu")(run) == 100.0 * flops / (1e-3 * 989e12)
    assert main.peak_rates(run) == "bf16 9.89e+14 FLOP/s"
