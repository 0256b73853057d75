"""fit_overhead_ms (ms, lower is better; program span), layer: the entry
points RBM.fit / DBN.fit. For each job span of the traced window, its wall
time less the device time the profiler puts inside it; the mean over the
window's jobs."""

from kubench.harness.trace import covered


def read(run):
    if run.trace is None or not run.trace.jobs or not run.trace.device:
        return None
    busy = run.trace.busy_merged()
    over = [(e - s) - covered(busy, s, e) for s, e in run.trace.jobs]
    return sum(over) / len(over) / 1e3
