"""The readers of the program's own spans (``kubench/metrics/entry_host_us``,
``launch_host_us``, ``program_idle_ms``, ``transform_device_ms``) and
:mod:`kubench.harness.spans` on a made-up Chrome trace: the arithmetic of
each, None where the trace holds no ``ku_torch.`` span (a program without
them), and None with a note where the launch spans and the launches the jobs
recorded differ in number."""

import json

import pytest

from kubench.harness import spans, spec, trace as tr
from kubench.harness.jobs import Job, Run

CELL = "dbn_hinton06.cd1"
KERNEL = "cd_gibbs_cluster_kernel(ClusterArgs, cc::Plan)"
READERS = ("entry_host_us", "launch_host_us", "program_idle_ms", "transform_device_ms")


def x(name, cat, ts, dur, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if args:
        e["args"] = {k.replace("_", " "): v for k, v in args.items()}
    return e


def events(program=True, skew=0.0):
    """A window of 1,000 us and two jobs. Each: ``rbm.fit`` (build, prep
    with a memset, ``cd_gibbs.launch`` with its ``call``, whose runtime call
    launches a CD kernel by its correlation), the synchronise; the second
    job ends with a transform whose operator launches an sgemm, linked by
    its External id alone. ``program`` False leaves out the program's spans,
    as the parent's trace has none; ``skew`` moves the second job's kernel
    that much earlier, as a device clock mapped ahead of the host's would."""
    harness = [x(tr.WINDOW, "user_annotation", 0, 1000),
               x(tr.JOB, "user_annotation", 50, 400), x(tr.JOB, "user_annotation", 460, 440),
               x("cudaDeviceSynchronize", "cuda_runtime", 200, 245),
               x("cudaDeviceSynchronize", "cuda_runtime", 600, 290)]
    mine = [x("ku_torch.rbm.fit", "user_annotation", 60, 140),
            x("ku_torch.rbm.build", "user_annotation", 60, 20),
            x("ku_torch.rbm.prep", "user_annotation", 80, 20),
            x("ku_torch.cd_gibbs.launch", "user_annotation", 120, 70),
            x("ku_torch.cd_gibbs.call", "user_annotation", 150, 35),
            x("ku_torch.rbm.fit", "user_annotation", 470, 130),
            x("ku_torch.cd_gibbs.launch", "user_annotation", 520, 70),
            x("ku_torch.cd_gibbs.call", "user_annotation", 550, 35),
            x("ku_torch.rbm.transform", "user_annotation", 880, 15)]
    host = [x("cudaMemsetAsync", "cuda_runtime", 82, 2, correlation=3),
            x("cudaLaunchKernelExC", "cuda_runtime", 160, 20, correlation=7),
            x("cudaLaunchKernelExC", "cuda_runtime", 560, 15, correlation=9),
            x("aten::mm", "cpu_op", 885, 4, External_id=42)]
    device = [x("Memset (Device)", "gpu_memset", 85, 5, correlation=3),
              x(KERNEL, "kernel", 195, 245, correlation=7),
              x(KERNEL, "kernel", 600 - skew, 280, correlation=9),
              x("sgemm_128x64_nn", "kernel", 890, 8, correlation=11, External_id=42)]
    return harness + (mine if program else []) + host + device


def make_run(tmp_path, monkeypatch, program=True, skew=0.0):
    path = tmp_path / f"{CELL}.trace.json"
    path.write_text(json.dumps({"traceEvents": events(program, skew)}))
    monkeypatch.setattr(spans, "trace_path", lambda cell: tmp_path / f"{cell}.trace.json")
    launch = {"rows": 60032, "v": 784, "h": 128, "batch": 128, "k": 1, "epochs": 1,
              "route": "cluster", "planned": "cluster"}
    jobs = [Job(seed=i, samples=1, flops=1, launches=[dict(launch)], wall_s=4e-4)
            for i in range(2)]
    return Run(CELL, jobs, 9.0, 1e-3, None, "H100, 700.00 W", tr.read(path))


def test_each_reader_on_a_made_up_trace(tmp_path, monkeypatch):
    run = make_run(tmp_path, monkeypatch)
    read = {name: spec.reader(name)(run) for name in READERS}
    # rbm.fit 140 us less its launch child's 70; then 130 less 70.
    assert read["entry_host_us"] == pytest.approx((70 + 60) / 2)
    assert read["launch_host_us"] == pytest.approx(70)
    # Idle inside the program's spans: 60..85 and 90..195 in job 1,
    # 440..600 clipped to the fit's 470..600 and 880..890 in job 2.
    assert read["program_idle_ms"] == pytest.approx((25 + 105 + 130 + 10) / 2 / 1e3)
    # The sgemm (8 us) is the one operation launched inside the transform,
    # found by its External id; the kernels' launches lie outside it.
    assert read["transform_device_ms"] == pytest.approx(8 / 2 / 1e3)
    assert not run.notes


def test_no_program_span_reads_none(tmp_path, monkeypatch):
    run = make_run(tmp_path, monkeypatch, program=False)
    assert all(spec.reader(name)(run) is None for name in READERS)
    assert not run.notes


def test_launch_spans_and_recorded_launches_differ(tmp_path, monkeypatch):
    run = make_run(tmp_path, monkeypatch)
    run.jobs[1].launches.append(dict(run.jobs[1].launches[0]))
    assert spec.reader("launch_host_us")(run) is None
    assert any("launch_host_us" in n for n in run.notes)


def test_a_kernel_before_its_launch_is_noted(tmp_path, monkeypatch):
    run = make_run(tmp_path, monkeypatch, skew=70)      # starts at 530, its call at 550
    assert spec.reader("program_idle_ms")(run) is not None
    assert any("1 of 2 CD kernels start before" in n and "20.0 us" in n for n in run.notes)
    assert spans.launch_gaps(run.trace, spans.read_links(spans.trace_path(CELL)))[
        "negative"] == 1


def test_a_trace_file_of_another_run_is_not_read(tmp_path, monkeypatch):
    run = make_run(tmp_path, monkeypatch)
    run.trace.window = (0.0, 999.0)
    assert spec.reader("transform_device_ms")(run) is None and run.notes


def test_the_report_of_a_trace(tmp_path, monkeypatch):
    run = make_run(tmp_path, monkeypatch)
    links = spans.read_links(spans.trace_path(CELL))
    gaps = spans.launch_gaps(run.trace, links)
    assert gaps == {"calls": 2, "kernels": 2, "matched": "link", "min_us": 45.0,
                    "median_us": 47.5, "negative": 0}
    by = spans.idle_by_span(run.trace)
    assert by["ku_torch.cd_gibbs.call"] == pytest.approx((35 + 35) / 2)
    assert by["cudaDeviceSynchronize"] == pytest.approx(5 / 2)
    assert by["ku_torch.rbm.build"] == pytest.approx(20 / 2)
    idle = sum(e - s for s, e in spans.idle(run.trace))
    assert sum(by.values()) == pytest.approx(idle / 2)
    device = spans.device_by_span(run.trace, links)
    assert device["ku_torch.rbm.transform"] == pytest.approx(8 / 2 / 1e3)
    assert device["ku_torch.cd_gibbs.call"] == pytest.approx((245 + 280) / 2 / 1e3)
    assert device["ku_torch.rbm.prep"] == pytest.approx(5 / 2 / 1e3)
