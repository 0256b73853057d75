"""The port's own spans on the CD path (``ku_torch.utils.trace.trace``).

Under ``torch.profiler`` the entry points and the kernel wrapper leave
``ku_torch.``-named regions in the Chrome trace: ``rbm.fit`` around
``rbm.build`` and ``rbm.prep`` (and, on the card, ``cd_gibbs.launch`` with
its ``plan``, ``alloc`` and ``call``), ``rbm.transform``, and one
``dbn.layer<i>`` per layer of ``DBN.fit``. With no profiler running,
``trace`` is a shared null context that never reaches ``record_function``,
and the spans change no number a fit computes.

The card test needs an NVIDIA GPU and imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_trace_spans.py -q
"""

import json

import pytest
import torch

from ku_torch.ebm import DBN, RBM
from ku_torch.kernels import cd_gibbs
from ku_torch.utils.trace import step_trace, trace

HPS = {"lr": 1e-2, "batch_size": 32, "epochs": 2}
FITS = {"kernel": {}, "scan": {"backend": "scan"}, "pcd": {"persistent": True}}


def rows(n=100, v=12, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, v, generator=g) < 0.3).float()


def spans(prof, tmp_path, prefix="ku_torch."):
    """(name, start us, end us) of the host regions whose name starts with
    ``prefix``, from the profile's Chrome trace, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith(prefix)), key=lambda s: s[1])


def inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def rbm_fit(fit, device="cpu"):
    return RBM(dict(HPS, **FITS[fit]), 7, seed=3, device=device).fit(rows(), verbose=0)


def dbn_fit(device="cpu"):
    dbn = DBN()
    for i, h in enumerate((10, 8, 6)):
        dbn.add_stack(RBM(HPS, h, seed=10 + i, device=device))
    return dbn.fit(rows(), verbose=0)


@pytest.mark.parametrize("fit", sorted(FITS))
def test_rbm_fit_span_holds_build_and_prep(fit, tmp_path):
    prof, _ = profiled(lambda: rbm_fit(fit))
    found = spans(prof, tmp_path)
    fits = [s for s in found if s[0] == "ku_torch.rbm.fit"]
    assert len(fits) == 1
    for name in ("ku_torch.rbm.build", "ku_torch.rbm.prep"):
        mine = [s for s in found if s[0] == name]
        assert len(mine) == 1 and inside(mine[0], fits[0]), (name, found)
    build, prep = (next(s for s in found if s[0] == n)
                   for n in ("ku_torch.rbm.build", "ku_torch.rbm.prep"))
    assert build[2] <= prep[1]


def test_dbn_fit_has_a_span_per_layer(tmp_path):
    prof, _ = profiled(dbn_fit)
    found = spans(prof, tmp_path)
    layers = [s for s in found if s[0].startswith("ku_torch.dbn.")]
    assert [s[0] for s in layers] == [f"ku_torch.dbn.layer{i}" for i in range(3)]
    for layer in layers:
        for name in ("ku_torch.rbm.fit", "ku_torch.rbm.transform"):
            assert sum(s[0] == name and inside(s, layer) for s in found) == 1, (layer, name)
        fit = next(s for s in found if s[0] == "ku_torch.rbm.fit" and inside(s, layer))
        transform = next(s for s in found
                         if s[0] == "ku_torch.rbm.transform" and inside(s, layer))
        assert fit[2] <= transform[1]


def outputs(model):
    layers = model.rbm_layers if isinstance(model, DBN) else [model]
    return [t for rbm in layers for t in (*rbm.params.values(), rbm.last_scores)]


@pytest.mark.parametrize("run", ["rbm_kernel", "rbm_scan", "rbm_pcd", "dbn"])
def test_spans_change_no_number(run):
    fit = dbn_fit if run == "dbn" else (lambda: rbm_fit(run[4:]))
    _, traced = profiled(fit)
    plain = outputs(fit())
    assert len(plain) == len(outputs(traced))
    for a, b in zip(plain, outputs(traced)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("run", ["rbm_kernel", "dbn", "trace", "step_trace"])
def test_no_profiler_never_enters_record_function(run, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    if run == "rbm_kernel":
        rbm_fit("kernel").transform(rows())
    elif run == "dbn":
        dbn_fit()
    elif run == "trace":
        with trace("ku_torch.x", step=1) as t:
            assert t is None
        assert trace("ku_torch.a") is trace("ku_torch.b", k=2)
    else:
        with step_trace("ku_train_step", 3):
            pass


@pytest.mark.cuda
def test_a_launch_span_links_to_its_kernel(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CD kernel has no plain version on the card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    params = {"rbm_weight": 0.1 * torch.randn(40, 24, device=dev, generator=g),
              "hidden_bias": torch.zeros(24, device=dev),
              "visible_bias": torch.zeros(40, device=dev)}
    v_all = (torch.rand(128, 40, device=dev, generator=g) < 0.3).float()
    mask = torch.ones(128, device=dev)
    args = (params, v_all, mask, 7, 1e-3, 1, cd_gibbs.MODE_VISIBLE_BERNOULLI, 32, 1)
    cd_gibbs.cd_train_cuda(*args)  # builds and loads the library outside the profile
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        cd_gibbs.cd_train_cuda(*args)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    found = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith("ku_torch.")), key=lambda s: s[1])
    launches = [s for s in found if s[0] == "ku_torch.cd_gibbs.launch"]
    assert len(launches) == 1
    children = {n: [s for s in found if s[0] == f"ku_torch.cd_gibbs.{n}"]
                for n in ("plan", "alloc", "call")}
    assert all(len(c) == 1 and inside(c[0], launches[0]) for c in children.values()), found
    call = children["call"][0]
    kernels = [e for e in events if e.get("cat") == "kernel" and "cd_gibbs" in e["name"]]
    assert len(kernels) == 1
    kernel = kernels[0]
    # The trace's own link: the kernel's correlation id is that of the
    # CUDA API call that launched it, and that call lies in the span.
    corr = kernel.get("args", {}).get("correlation")
    launchers = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and e.get("args", {}).get("correlation") == corr]
    assert launchers and all(call[1] <= e["ts"] <= call[2] for e in launchers), launchers
    assert kernel["ts"] >= call[1]
