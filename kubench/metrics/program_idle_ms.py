"""program_idle_ms (ms, lower is better; device trace), layer: the device.
Per job, the window's time with no device operation that falls inside the
union of the program's ``ku_torch.`` spans: the device waiting on the
program's host work. The rest of ``device_idle`` is the harness, the
return from the synchronise and the launch's latency.

The idle time is the device's and the spans are the host's, so the reading
holds only as far as the profiler's mapping of the device's clock onto the
host's does: where a CD kernel starts before the ``ku_torch.cd_gibbs.call``
span that launched it, the run says so, and by how much."""

from kubench.harness import spans
from kubench.harness.trace import merge


def read(run):
    trace = run.trace
    if trace is None or not trace.jobs:
        return None
    mine = spans.program(trace)
    if not mine:
        return None
    links = spans.run_links(run)
    gaps = spans.launch_gaps(trace, links) if links is not None else {}
    if gaps.get("negative"):
        run.note(f"{gaps['negative']} of {gaps['calls']} CD kernels start before their "
                 f"{spans.CALL} span, by up to {-gaps['min_us']:.1f} us: the device's "
                 f"clock as mapped onto the host's runs ahead, and idle time falls in the "
                 f"wrong spans by as much")
    hi = trace.window[1]
    union = merge((s, min(e, hi)) for _, s, e in mine)
    return spans.overlap(union, spans.idle(trace)) / len(trace.jobs) / 1e3
