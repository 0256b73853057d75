"""Driver ``rbm_fit``: a job is ``RBM(hps, output_dim, seed=s).fit(rows)``
of ``ku_torch.ebm``, on a fresh RBM each time, with the run's rows. On the
card the whole fit is one launch of kernel #1 (``cd_gibbs``), whose route
the job reads back from ``cd_gibbs.last_launch()``.

The check repeats the job in :mod:`kubench.reference.cd` from the same
rows and seed, and compares its first steps' scores and the change of each
parameter over the whole job (:mod:`kubench.harness.compare`).
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

from kubench.harness import compare, counts, spec
from kubench.harness.jobs import Job
from kubench.reference import cd as ref

HPS = ("lr", "batch_size", "epochs", "k")
PARAMS = (("rbm_weight", "W"), ("hidden_bias", "b_h"), ("visible_bias", "b_v"))

# The faults a training cell can have, for ``kubench/calibrate.py`` and the
# tests (the exchange between chips does not exist on one chip): a fit that
# returns its state unchanged; half of each batch left out, its mean taken
# over the rest (raw sums at twice the rate, the score over the half); an
# answer altered where it is produced (the kernel's trained visible bias
# replaced by its input).
FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def settings(config: dict, traffic: dict) -> dict:
    """The training settings a job runs: the configuration's (its
    ``rbm_hps`` group where it has one, as the upstream example's conf,
    else its top-level keys), with the mix's ``hps`` over them."""
    group = config.get("rbm_hps", {})
    out = {key: group.get(key, config.get(key)) for key in HPS}
    out.update(traffic.get("hps", {}))
    missing = [key for key in HPS if out[key] is None]
    if missing:
        raise ValueError(f"no {', '.join(missing)} in the configuration or the mix")
    return {"lr": float(out["lr"]), "batch_size": int(out["batch_size"]),
            "epochs": int(out["epochs"]), "k": int(out["k"])}


class Launches:
    """What the drivers of kernel #1 share: its launch counter, and each
    launch's shape with the route the C entry reports beside the route
    that ``cluster_plan`` gives the shape."""

    def __init__(self, cd_gibbs, hps: dict, on_card: bool):
        self.cd_gibbs, self.hps, self.on_card = cd_gibbs, hps, on_card
        self.start = 0
        self.plans = {}      # (v, h) -> route; a plan takes up to 0.5 ms to work out

    def count(self) -> int:
        return self.cd_gibbs.cd_train_cuda.launches

    def record(self, rows: int, v: int, h: int, route) -> dict:
        hp = self.hps
        if (v, h) not in self.plans:
            self.plans[v, h] = self.cd_gibbs.cluster_plan(hp["batch_size"], v, h)["route"]
        return {"rows": rows, "v": v, "h": h, "batch": hp["batch_size"], "k": hp["k"],
                "epochs": hp["epochs"], "route": route, "planned": self.plans[v, h]}

    def mark(self) -> None:
        self.start = self.count()

    def summary(self, jobs) -> tuple:
        """(the window's launches by shape and route, launches off plan or
        uncounted); off the card no route is reported or checked."""
        counted = self.count() - self.start
        launches = [l for job in jobs for l in job.launches]
        by_route = {}
        for l in launches:
            key = f"{l['v']}x{l['h']} {l['route']}"
            by_route[key] = by_route.get(key, 0) + 1
        off = 0
        if self.on_card:
            off = sum(l["route"] != l["planned"] for l in launches) + abs(counted - len(launches))
        return ({"counted": counted, "recorded": len(launches),
                 "a_job": len(launches) / max(len(jobs), 1), "by_shape_route": by_route,
                 "planned": {f"{l['v']}x{l['h']}": l["planned"] for l in jobs[0].launches}},
                off)


class Driver:
    def __init__(self, torch, config: dict, traffic: dict, seed: int, device, spans: bool):
        from ku_torch.ebm import RBM
        from ku_torch.kernels import cd_gibbs

        self.RBM, self.cd_gibbs = RBM, cd_gibbs
        self.hps = settings(config, traffic)
        self.h = int(config["nn_arch"]["output_dim"])
        self.rows = spec.generator(traffic["kind"]).make(torch, config, traffic, seed, device)
        self.device = device
        self.on_card = device.type == "cuda"
        self.counter = Launches(cd_gibbs, self.hps, self.on_card)

    def mark(self) -> None:
        self.counter.mark()

    def summary(self, jobs) -> tuple:
        return self.counter.summary(jobs)

    def job(self, seed: int) -> Job:
        rbm = self.RBM(self.hps, self.h, seed=seed, device=self.device)
        rbm.fit(self.rows, verbose=0)
        n, v = self.rows.shape
        hp = self.hps
        route = self.cd_gibbs.last_launch()["route"] if self.on_card else None
        return Job(seed=seed, samples=n * hp["epochs"],
                   flops=counts.cd_flops(n, v, self.h, hp["batch_size"], hp["k"], hp["epochs"]),
                   launches=[self.counter.record(n, v, self.h, route)],
                   scores=[rbm.last_scores], answer=rbm)

    def check(self, job: Job) -> tuple:
        """(the numbers compared; the step at which the program's scores
        leave the reference's, a diagnostic)."""
        hp = self.hps
        with ref.precision(tf32=False):
            want = ref.rbm_fit(job.seed, self.rows, self.h, hp["lr"], hp["k"],
                               hp["batch_size"], hp["epochs"])
        got = job.answer
        values = {"loss_gap": first_gap(got.last_scores, want, self.rows, hp),
                  "delta_gap": compare.delta_gap(leaves(got.params, want))}
        return values, {"diverge_step": compare.diverge_step(got.last_scores, want.scores)}

    def control(self, seed: int) -> Job:
        """The job of seed ``seed`` done by the reference in TF32, in the
        program's place (the control of the comparison)."""
        hp = self.hps
        with ref.precision(tf32=True):
            r = ref.rbm_fit(seed, self.rows, self.h, hp["lr"], hp["k"], hp["batch_size"],
                            hp["epochs"])
        answer = SimpleNamespace(params={p: r.end[n] for p, n in PARAMS}, last_scores=r.scores)
        return Job(seed=seed, samples=0, flops=0, launches=[], answer=answer)


def first_gap(scores, want: ref.LayerFit, V, hps: dict) -> float:
    """``loss_gap`` of the program's ``scores`` against the reference run
    ``want`` on ``V``, over the first :data:`compare.LOSS_STEPS` steps,
    on the path of near-threshold draws closest to the program's."""
    got = scores[:compare.LOSS_STEPS]
    first = ref.first_scores(want.start, V, want.seed32, hps["lr"], hps["k"],
                             hps["batch_size"], got)
    return compare.loss_gap(got, first)


def leaves(params: dict, want: ref.LayerFit) -> list:
    """(program's change, reference's change) of each parameter. Both are
    taken from the reference's start, which draws the program's own."""
    return [(params[p] - want.start[r], want.end[r] - want.start[r]) for p, r in PARAMS]


@contextlib.contextmanager
def fault(name: str):
    """Break the program underneath its entry points, as :data:`FAULTS`
    (and, for a stack, ``transform_altered``: the transform's first row
    flipped) says, for the duration of the block."""
    from ku_torch.ebm import rbm as rbm_module
    from ku_torch.kernels import cd_gibbs

    train, sample_hidden = cd_gibbs.cd_train, rbm_module.sample_hidden

    def unchanged(params, v_all, mask, seed, lr, k, mode, batch_size, epochs):
        _, scores = train(params, v_all, mask, seed, lr, k, mode, batch_size, epochs)
        return {n: t.clone() for n, t in params.items()}, scores

    def half_batch(params, v_all, mask, seed, lr, k, mode, batch_size, epochs):
        keep = (v_all.new_ones(v_all.shape[0]).cumsum(0) - 1) % batch_size < batch_size // 2
        return train(params, v_all, mask * keep, seed, 2 * lr, k, mode, batch_size, epochs)

    def bias_dropped(params, v_all, mask, seed, lr, k, mode, batch_size, epochs):
        out, scores = train(params, v_all, mask, seed, lr, k, mode, batch_size, epochs)
        return dict(out, visible_bias=params["visible_bias"].clone()), scores

    def transform_altered(p, v, generator, mode=0):
        h = sample_hidden(p, v, generator, mode)
        h[0] = 1.0 - h[0]
        return h

    patches = {"state_unchanged": (cd_gibbs, "cd_train", unchanged),
               "half_batch": (cd_gibbs, "cd_train", half_batch),
               "answer_altered": (cd_gibbs, "cd_train", bias_dropped),
               "transform_altered": (rbm_module, "sample_hidden", transform_altered)}
    module, attr, broken = patches[name]
    saved = getattr(module, attr)
    setattr(module, attr, broken)
    try:
        yield
    finally:
        setattr(module, attr, saved)
