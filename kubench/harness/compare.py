"""The numbers that decide ``correct``, each against its limit.

A training job's answer is its trained parameters and its per-step
scores. The reference repeats the job from the same inputs and seeds, and
the program's answer is judged by:

- ``loss_gap``: the largest relative gap between the program's and the
  reference's scores over the first three steps of each RBM. A draw that
  lies within rounding of its threshold may fall either way in a sound
  program, and from there the two runs part (on the H100 within 11 to a few
  hundred steps, or never, in one epoch). So the reference follows the
  first steps along each way such draws may fall, and the program is held
  to the path closest to it; later steps are not compared.
- ``delta_gap``: by the worst leaf (W, b_h, b_v of each RBM), the gap
  between the norms of the program's and the reference's change over the
  whole job, against the larger of that leaf's and the median leaf's
  reference norm (the gap of the norms, not the norm of the difference).
  The whole job, not three steps: the kernel runs the job in one launch,
  so the program's state after a step is not there to read.
- ``transform_gap`` (stacks only): the largest share of a transform's
  entries, over the layers, that differ from the reference's.
"""

from __future__ import annotations

import statistics

LOSS_STEPS = 3


def loss_gap(got, want) -> float:
    """The largest relative gap between the program's scores ``got`` and
    the reference's ``want`` over ``want``'s steps."""
    g, w = got[:len(want)].double().cpu(), want.double().cpu()
    return float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())


def diverge_step(got, want, tol: float = 1e-5) -> int:
    """The first step whose scores differ by more than ``tol`` of the
    reference's, or the number of steps if none does (a diagnostic, not
    compared)."""
    gap = (got.double() - want.double()).abs() / want.double().abs().clamp_min(1e-30)
    over = (gap > tol).nonzero()
    return int(over[0, 0]) if len(over) else int(gap.numel())


def delta_gap(leaves) -> float:
    """``leaves``: (program's change, reference's change) pairs. A leaf
    whose reference change is under a thousandth of the median leaf's
    moves by rounding alone and is left out."""
    norms = [(float(g.double().norm()), float(w.double().norm())) for g, w in leaves]
    median = statistics.median(w for _, w in norms)
    kept = [(g, w) for g, w in norms if w >= 1e-3 * median]
    return max(abs(g - w) / max(w, median, 1e-30) for g, w in kept)


def mismatch_share(got, want) -> float:
    return float((got != want).double().mean())


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit. A number without a limit is a fault of the configuration."""
    checks, ok = {}, True
    for name, value in values.items():
        if name not in limits:
            raise KeyError(f"no limit for {name!r} in the configuration's limits")
        limit = float(limits[name])
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value == value and value <= limit  # NaN fails
    return ok, checks
