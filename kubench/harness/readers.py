"""Arithmetic the metric readers share. Each reader returns None where its
run holds nothing for it to read; it never returns 0 for a share."""

from __future__ import annotations

from kubench.harness import counts


def cd_roofline(run, route: str, pattern):
    """Percent of the least time the cd_gibbs launches of ``route`` could
    take, over their device time: the least time of a launch is the larger
    of its operations at the card's dense TF32 peak and its bytes at the
    memory's bandwidth. The i-th kernel of ``pattern`` in the trace is the
    i-th launch of the route that the jobs recorded."""
    if run.trace is None or run.peaks is None:
        return None
    launches = run.launches(route)
    kernels = run.trace.kernels(pattern)
    if not launches:
        return None
    if len(kernels) != len(launches):
        run.note(f"{route} route: {len(launches)} launches recorded, {len(kernels)} "
                 f"kernels of {pattern.pattern} in the trace; no roofline read")
        return None
    least = sum(counts.least_seconds(
        counts.cd_flops(l["rows"], l["v"], l["h"], l["batch"], l["k"], l["epochs"]),
        counts.cd_bytes(l["rows"], l["v"], l["h"], l["batch"], l["epochs"]),
        run.peaks["tf32"], run.peaks["bytes_per_s"])[0] for l in launches)
    device = sum(e - s for _, s, e in kernels) / 1e6
    return 100.0 * least / device if device > 0 else None
