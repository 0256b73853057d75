"""Driver ``dbn_fit``: a job is ``DBN.fit(rows)`` of ``ku_torch.ebm`` on a
fresh stack of RBMs of the configuration's ``layers`` widths: each RBM is
fitted (one launch of kernel #1 on the card), then transforms its input
into the next one's (plain torch ops).

The stack's RBMs are a subclass of the program's ``RBM`` that changes no
arithmetic: after its ``fit`` it reads the route of its launch back from
``cd_gibbs.last_launch()``, it keeps the output of its ``transform`` for the
check, and in a traced run it puts a span around each call.

The check repeats each layer's fit in the reference and compares it as
the RBM cell does. It follows its own state from the run's rows for as
long as it can: while every layer so far ended where the program's did
(each parameter within :data:`OWN_GAP`) and drew the program's transform
entry for entry, a layer's transform is judged from the reference's own
trained layer, and the next layer trains on the reference's own transform.
A fit that parts from the program at a draw within rounding of its
threshold (see :mod:`kubench.harness.compare`) ends that: its transform is
then judged from the program's trained layer with the reference's draw,
and the later layers train on the program's transform. ``own_layers``
says how many layers were judged from the rows alone.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

from kubench.drivers import rbm_fit
from kubench.drivers.rbm_fit import PARAMS, Launches, first_gap, leaves, settings
from kubench.harness import compare, counts, spec
from kubench.harness.jobs import Job
from kubench.harness.traffic import mix
from kubench.reference import cd as ref
from kubench.reference.philox import SeedStream

# A layer ends where the program's did when no parameter differs by more
# than this: one draw that falls the other way moves a row or a column of
# W by lr times a probability or a pixel (ku's lr multiplies the batch's
# summed statistics: 1e-4 to 1e-3 here), rounding alone far less.
OWN_GAP = 1e-5

# The RBM's faults, and the transform's first row flipped (``fault``
# plants each).
FAULTS = rbm_fit.FAULTS + ("transform_altered",)
fault = rbm_fit.fault


def layer_seed(job_seed: int, layer: int) -> int:
    return mix(job_seed, "layer", layer)


def param_gap(params: dict, want: ref.LayerFit) -> float:
    """The largest entry-wise gap between the program's trained parameters
    and the reference's."""
    return max(float((params[p] - want.end[r]).abs().max()) for p, r in PARAMS)


class Driver:
    def __init__(self, torch, config: dict, traffic: dict, seed: int, device, spans: bool):
        from ku_torch.ebm import DBN, RBM
        from ku_torch.kernels import cd_gibbs

        on_card = device.type == "cuda"
        span = torch.profiler.record_function if spans else (lambda name: contextlib.nullcontext())

        class LayerRBM(RBM):
            """The program's RBM, recording its launch and its transform."""

            def fit(self, V, verbose=1, mesh=None):
                with span(f"kubench.fit.layer{self.layer}"):
                    super().fit(V, verbose=verbose, mesh=mesh)
                self.route = cd_gibbs.last_launch()["route"] if on_card else None
                return self

            def transform(self, v, generator=None):
                with span(f"kubench.transform.layer{self.layer}"):
                    self.out = super().transform(v, generator)
                return self.out

        self.DBN, self.LayerRBM = DBN, LayerRBM
        self.hps = settings(config, traffic)
        self.widths = [int(w) for w in config["layers"]]
        self.rows = spec.generator(traffic["kind"]).make(torch, config, traffic, seed, device)
        self.device = device
        self.counter = Launches(cd_gibbs, self.hps, on_card)

    def mark(self) -> None:
        self.counter.mark()

    def summary(self, jobs) -> tuple:
        return self.counter.summary(jobs)

    def job(self, seed: int) -> Job:
        dbn = self.DBN()
        for i, h in enumerate(self.widths[1:]):
            rbm = self.LayerRBM(self.hps, h, seed=layer_seed(seed, i), device=self.device)
            rbm.layer = i
            dbn.add_stack(rbm)
        dbn.fit(self.rows, verbose=0)
        n, hp = self.rows.shape[0], self.hps
        flops, launches = 0, []
        for v, h, rbm in zip(self.widths, self.widths[1:], dbn.rbm_layers):
            flops += (counts.cd_flops(n, v, h, hp["batch_size"], hp["k"], hp["epochs"])
                      + counts.transform_flops(n, v, h))
            launches.append(self.counter.record(n, v, h, rbm.route))
        return Job(seed=seed, samples=n * hp["epochs"] * len(dbn.rbm_layers), flops=flops,
                   launches=launches, scores=[rbm.last_scores for rbm in dbn.rbm_layers],
                   answer=dbn)

    def control(self, seed: int) -> Job:
        """The job of seed ``seed`` done by the reference in TF32, in the
        program's place (the control of the comparison)."""
        hp, widths = self.hps, self.widths[1:]
        with ref.precision(tf32=True):
            fits = ref.dbn_fit([layer_seed(seed, i) for i in range(len(widths))], self.rows,
                               widths, hp["lr"], hp["k"], hp["batch_size"], hp["epochs"])
        layers = [SimpleNamespace(params={p: f.end[r] for p, r in PARAMS},
                                  last_scores=f.scores, out=f.out) for f in fits]
        return Job(seed=seed, samples=0, flops=0, launches=[],
                   answer=SimpleNamespace(rbm_layers=layers))

    def check(self, job: Job) -> tuple:
        """(the numbers compared, the worst over the layers; diagnostics:
        per layer the step at which the program's scores leave the
        reference's, the parameters' largest gap, the share of transform
        entries that differ from the reference's own draw and from its
        draw with the program's layer, and how many layers were judged
        from the rows alone)."""
        hp = self.hps
        loss, tgap, pairs = 0.0, 0.0, []
        info = {"diverge_step": [], "param_gap": [], "own_share": [], "their_share": [],
                "own_layers": 0}
        own, v_in = True, self.rows
        with ref.precision(tf32=False):
            for i, rbm in enumerate(job.answer.rbm_layers):
                seed = layer_seed(job.seed, i)
                want = ref.rbm_fit(seed, v_in, self.widths[i + 1], hp["lr"], hp["k"],
                                   hp["batch_size"], hp["epochs"], with_transform=True)
                loss = max(loss, first_gap(rbm.last_scores, want, v_in, hp))
                pairs += leaves(rbm.params, want)
                gap = param_gap(rbm.params, want)
                # The program's trained layer with the reference's draw (the
                # stream's third seed, as ``want.out``'s).
                seeds = SeedStream(seed)
                seeds.seed64(), seeds.seed64()
                p = {"W": rbm.params["rbm_weight"], "b_h": rbm.params["hidden_bias"]}
                theirs = ref.transform(p, v_in, seeds.generator(v_in.device))
                own = own and gap <= OWN_GAP
                drawn = want.out if own else theirs
                tgap = max(tgap, compare.mismatch_share(rbm.out, drawn))
                info["diverge_step"].append(compare.diverge_step(rbm.last_scores, want.scores))
                info["param_gap"].append(gap)
                info["own_share"].append(compare.mismatch_share(rbm.out, want.out))
                info["their_share"].append(compare.mismatch_share(rbm.out, theirs))
                info["own_layers"] += own
                own = own and bool((rbm.out == want.out).all())
                v_in = want.out if own else rbm.out
        values = {"loss_gap": loss, "delta_gap": compare.delta_gap(pairs), "transform_gap": tgap}
        return values, info
