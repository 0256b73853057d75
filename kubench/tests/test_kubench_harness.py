"""The harness on the CPU: every name in BENCHMARK.json finds its files,
every number a cell's check returns has its limit, the ``"small"``
presets, the operation and byte counts, the end-to-end arithmetic over a
window with a stall, ``mfu`` at each job's own peak, and the trace readers
on a made-up trace. One test runs a cell on the card and skips without
one. The per-cell checks are functions of a BENCHMARK.json and a root, so
that a cell defined elsewhere (``test_kubench_contract.py``) passes the
same ones."""

import json
import re
import subprocess
import sys

import pytest
import torch

from kubench.harness import card, counts, spec, trace as tr, traffic as tf
from kubench.harness.jobs import Job, Run

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
H100 = {"match": "H100", "tf32": 495e12, "bytes_per_s": 3.35e12}
CPU = torch.device("cpu")


def check_benchmark(bench: dict) -> None:
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"][:2] == ["python3", "kubench/run.py"] and bench["paths"] == ["kubench"]
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("kubench/") and len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    assert len(json.dumps(bench)) < 64 * 1024


def test_benchmark_json_keys_names_and_sizes():
    check_benchmark(BENCH)


def check_resolves(bench: dict, cell: str, root=spec.ROOT) -> None:
    """The cell's files, found by name, and at least one limit."""
    c = spec.load_cell(cell, bench, root)
    assert c.config["name"] == next(w["config"] for w in bench["workloads"] if w["name"] == cell)
    assert hasattr(c.driver(), "Driver")
    assert callable(spec.generator(c.traffic["kind"], c.home).make)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    assert c.config["limits"]


def check_limits(bench: dict, cell: str, root=spec.ROOT) -> None:
    """Every number ``Driver.check`` returns, in a run at the cell's
    ``"small"`` size on the CPU, has a limit in its configuration."""
    c = spec.load_cell(cell, bench, root, small=True)
    seed = 2**31 + 9
    driver = c.driver().Driver(torch, c.config, c.traffic, seed, CPU, False)
    values, _ = driver.check(driver.job(tf.job_seed(seed, 0)))
    assert values and set(values) <= set(c.config["limits"]), (values, c.config["limits"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_by_name(cell):
    check_resolves(BENCH, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_every_number_checked_has_its_limit(cell):
    check_limits(BENCH, cell)


def file_less_small(path) -> dict:
    data = json.loads(path.read_text())
    data.pop("small", None)
    return data


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_the_files_less_small(cell):
    """What a run drives: the files' contents, without the test preset."""
    c = spec.load_cell(cell, BENCH)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    config = next(x for x in BENCH["configs"] if x["name"] == w["config"])
    assert c.config == file_less_small(spec.ROOT / config["file"])
    assert c.traffic == file_less_small(spec.BENCH / "traffic" / f"{w['traffic']}.json")
    assert "small" not in c.config and "small" not in c.traffic


def test_the_cd_mix_is_as_it_was():
    traffic = spec.load_cell("rbm_mnist.cd1", BENCH).traffic
    assert {k: traffic[k] for k in ("kind", "rows", "density", "hps")} == {
        "kind": "bernoulli_rows", "rows": 60032, "density": 0.13, "hps": {"k": 1}}


@pytest.mark.parametrize("cell", CELLS)
def test_small_puts_the_presets_over_the_files(cell):
    c, s = spec.load_cell(cell, BENCH), spec.load_cell(cell, BENCH, small=True)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    config = next(x for x in BENCH["configs"] if x["name"] == w["config"])
    raw_config = json.loads((spec.ROOT / config["file"]).read_text())
    raw_traffic = json.loads((spec.BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    assert s.config == {**c.config, **raw_config.get("small", {})} and "small" not in s.config
    assert s.traffic == {**c.traffic, **raw_traffic.get("small", {})} and "small" not in s.traffic
    if w["traffic"] == "cd1":              # the CD configurations run their widths
        assert s.config == c.config and s.traffic == dict(c.traffic, rows=130)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_its_reader(metric):
    assert callable(spec.reader(metric))


def test_counts_by_hand():
    # 784 x 128: 469 steps, 5 products of 2 x 128 x 784 x 128 a step.
    assert counts.cd_flops(60032, 784, 128, 128, 1, 1) == 60_243_312_640
    assert counts.cd_bytes(60032, 784, 128, 128, 1) == 4 * (60032 * 784 + 60032
                                                            + 2 * (100352 + 784 + 128) + 469)
    assert counts.cd_bytes(60032, 784, 128, 128, 1) == 189_312_468
    # 500 x 2000: 469 steps of 5 x 2 x 128 x 500 x 2000.
    assert counts.cd_flops(60032, 500, 2000, 128, 1, 1) == 600_320_000_000
    assert counts.cd_bytes(60032, 500, 2000, 128, 1) == 128_326_004
    assert counts.transform_flops(60032, 500, 2000) == 120_064_000_000
    # At the DBN cell's batch of 100 the last of 601 batches is padded:
    # padded rows count, operations and bytes alike.
    assert counts.cd_flops(60032, 500, 2000, 100, 1, 1) == 601_000_000_000
    assert counts.cd_bytes(60032, 500, 2000, 100, 1) == 4 * (60100 * 500 + 60100 + 2 * (
        1_000_000 + 500 + 2000) + 601) == 128_462_804
    # CD-2 makes 7 products a step; 60,000 rows pad to 469 batches.
    assert counts.cd_flops(60000, 784, 128, 128, 2, 1) == 7 * 2 * 128 * 784 * 128 * 469
    t, by = counts.least_seconds(60_243_312_640, 189_312_468, 495e12, 3.35e12)
    assert by == "operations" and t == pytest.approx(1.21704e-4, rel=1e-4)
    t, by = counts.least_seconds(1, 189_312_468, 495e12, 3.35e12)
    assert by == "bytes" and t == pytest.approx(5.6511e-5, rel=1e-4)


def stalled_window():
    """100 jobs of 33 ms, of which six in a row stall at 300 ms."""
    walls = [0.033] * 100
    walls[40:46] = [0.300] * 6
    jobs = [Job(seed=i, samples=60032, flops=1, launches=[], scores=[], wall_s=w)
            for i, w in enumerate(walls)]
    return Run("rbm_mnist.cd1", jobs, 9.0, sum(walls), H100, "H100, 700.00 W"), walls


def test_rate_and_p95_take_every_job_and_show_the_stall():
    run, walls = stalled_window()
    rate = spec.reader("samples_per_s")(run)
    p95 = spec.reader("job_ms.p95")(run)
    assert rate == pytest.approx(100 * 60032 / sum(walls))
    assert rate < 0.75 * 60032 / 0.033          # the stall costs a third of the rate
    assert p95 == pytest.approx(300.0)          # 6 of 100 stalled: the tail is the stall
    # Medians over chunks of ten jobs would have hidden it.
    chunks = [walls[i:i + 10] for i in range(0, 100, 10)]
    chunk_rates = sorted(60032 * len(c) / sum(c) for c in chunks)
    chunk_p95 = sorted(sorted(c)[9] for c in chunks)
    assert chunk_rates[5] == pytest.approx(60032 / 0.033)
    assert chunk_p95[5] == pytest.approx(33.0 / 1e3)


def write_trace(path):
    """A window of 1,000 us: two jobs, two cluster kernels, a memset."""
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    kernel = "cd_gibbs_cluster_kernel(ClusterArgs, cc::Plan)"
    events = [x(tr.WINDOW, "user_annotation", 0, 1000),
              x(tr.JOB, "user_annotation", 50, 400), x(tr.JOB, "user_annotation", 460, 440),
              x("Memset (Device)", "gpu_memset", 90, 5),
              x(kernel, "kernel", 100, 300), x(kernel, "kernel", 500, 300),
              x("cudaStreamSynchronize", "cuda_runtime", 400, 50),
              x("aten::rand", "cpu_op", 900, 80)]
    path.write_text(json.dumps({"traceEvents": events}))


def test_trace_readers_on_a_made_up_trace(tmp_path):
    path = tmp_path / "t.json"
    write_trace(path)
    t = tr.read(path)
    assert t.window_s == pytest.approx(1e-3) and t.busy_s == pytest.approx(605e-6)
    gaps = t.idle_gaps()
    assert gaps[0] == ["aten::rand", pytest.approx(200e-6)]     # 800 .. 1000 us
    assert ["cudaStreamSynchronize", pytest.approx(100e-6)] in gaps
    assert t.device_ops()[0][1] == pytest.approx(600e-6)
    launch = {"rows": 60032, "v": 784, "h": 128, "batch": 128, "k": 1, "epochs": 1,
              "route": "cluster", "planned": "cluster"}
    jobs = [Job(seed=i, samples=60032, flops=60_243_312_640, launches=[dict(launch)],
                scores=[], wall_s=0.0004) for i in range(2)]
    run = Run("rbm_mnist.cd1", jobs, 9.0, 1e-3, H100, "H100, 700.00 W", t)
    idle = spec.reader("device_idle")(run)
    assert idle == pytest.approx(39.5)
    # Job 1: 400 us less 305 us of device time; job 2: 440 less 300.
    assert spec.reader("fit_overhead_ms")(run) == pytest.approx((95 + 140) / 2 / 1e3)
    least = 2 * max(60_243_312_640 / 495e12, 189_312_468 / 3.35e12)
    assert spec.reader("roofline.cd_cluster")(run) == pytest.approx(100 * least / 600e-6)
    assert spec.reader("roofline.cd_global")(run) is None      # no global launch to read
    assert spec.reader("mfu")(run) == pytest.approx(
        100 * 2 * 60_243_312_640 / (1e-3 * 495e12))
    # The last kernel ends past the window's close on the mapped clock: it
    # still counts, as the window waited for it.
    late = [dict(e, dur=e["dur"] + 250) if e["ts"] == 500 else e
            for e in json.loads(path.read_text())["traceEvents"]]
    path.write_text(json.dumps({"traceEvents": late}))
    run.trace = tr.read(path)
    assert spec.reader("roofline.cd_cluster")(run) == pytest.approx(100 * least / 850e-6)
    # A launch the trace does not show: no roofline rather than a wrong one.
    run.jobs[0].launches.append(dict(launch))
    assert spec.reader("roofline.cd_cluster")(run) is None and run.notes


def traced_run(tmp_path, jobs, peaks) -> Run:
    path = tmp_path / "t.json"
    write_trace(path)
    return Run("rbm_mnist.cd1", jobs, 9.0, 1e-3, peaks, "H100, 700.00 W", tr.read(path))


def test_mfu_of_tf32_jobs_is_the_one_peak_formula(tmp_path):
    flops = [60_243_312_640, 601_000_000_000, 120_064_000_000, 7]
    run = traced_run(tmp_path, [Job(seed=i, samples=1, flops=f, launches=[])
                                for i, f in enumerate(flops)], H100)
    assert spec.reader("mfu")(run) == 100.0 * sum(flops) / (run.window_s * H100["tf32"])


def test_mfu_of_bf16_jobs_reads_at_the_bf16_peak(tmp_path):
    peaks = card.peaks("NVIDIA H100 80GB HBM3")
    assert peaks["bf16"] == 989e12
    jobs = [Job(seed=i, samples=1, flops=10**12, launches=[], peak="bf16") for i in range(3)]
    run = traced_run(tmp_path, jobs, peaks)
    assert spec.reader("mfu")(run) == pytest.approx(100 * 3e12 / (1e-3 * 989e12), rel=1e-12)
    jobs.append(Job(seed=3, samples=1, flops=495 * 10**9, launches=[]))   # a tf32 job
    assert spec.reader("mfu")(run) == pytest.approx(100 * (3e12 / 989e12 + 495e9 / 495e12) / 1e-3,
                                                    rel=1e-12)


@pytest.mark.parametrize("peak", ["fp8", "bytes_per_s", "match"])
def test_mfu_of_a_job_at_an_unknown_peak_reads_none(tmp_path, peak):
    jobs = [Job(seed=0, samples=1, flops=10**12, launches=[]),
            Job(seed=1, samples=1, flops=10**12, launches=[], peak=peak)]
    run = traced_run(tmp_path, jobs, card.peaks("NVIDIA H100 80GB HBM3"))
    assert spec.reader("mfu")(run) is None
    assert any("mfu" in n and peak in n for n in run.notes)


@pytest.mark.cuda
def test_a_short_run_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures nothing off the card")
    out = subprocess.run([sys.executable, str(spec.BENCH / "run.py"), "--workload",
                          "rbm_mnist.cd1", "--seed", str(2**31 + 5), "--seconds", "2",
                          "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"samples_per_s", "job_ms.p95", "setup_s"}
