"""A job as the harness sees it, and the run the metric readers read."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Job:
    """One call into the program, as a driver reports it.

    ``samples``: training examples it processes (a row through one CD epoch
    of one RBM counts one); ``flops``: the operations its work needs
    (:mod:`kubench.harness.counts`); ``launches``: one dict a kernel
    launch, in order, with its shape and the route the program reports;
    ``scores``: the tensors whose entries must all be finite, read once the
    window has closed; ``answer``: what the driver's ``check`` judges, kept
    only for the sampled jobs; ``peak``: the column of ``peaks.json`` (the
    card's dense FLOP/s in the job's own precision) at which ``mfu``
    counts its operations."""
    seed: int
    samples: int
    flops: int
    launches: list
    scores: list = field(default_factory=list)
    answer: object = None
    wall_s: float = 0.0
    peak: str = "tf32"


@dataclass
class Run:
    """What a run measured, for the metric readers (seconds unless named)."""
    cell: str
    jobs: list
    setup_s: float
    window_s: float
    peaks: dict                                  # None off the card
    card: str
    trace: object = None                         # harness.trace.Trace or None
    notes: list = field(default_factory=list)    # printed on standard error

    def note(self, msg: str) -> None:
        self.notes.append(msg)

    def flops_by_peak(self) -> dict:
        """The window's operations, summed by their jobs' ``peak``."""
        out = {}
        for job in self.jobs:
            out[job.peak] = out.get(job.peak, 0) + job.flops
        return out

    def launches(self, route: str) -> list:
        return [l for job in self.jobs for l in job.launches if l["route"] == route]
