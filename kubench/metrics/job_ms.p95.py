"""job_ms.p95 (ms, lower is better; host clock): the 95th percentile of
the wall times of every job of the window, each timed from the call to the
synchronise after it (linear interpolation between order statistics)."""

import statistics


def read(run):
    walls = [job.wall_s * 1e3 for job in run.jobs]
    if not walls:
        return None
    if len(walls) == 1:
        return walls[0]
    return statistics.quantiles(walls, n=100, method="inclusive")[94]
