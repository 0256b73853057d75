"""launch_host_us (us, lower is better; device trace), layer: the kernel
wrapper ku_torch/kernels/cd_gibbs.py. The mean duration of the window's
``ku_torch.cd_gibbs.launch`` spans: the wrapper's checks, the route's plan,
the copies and scratch, and the C entry that launches kernel #1. Read only
where the spans are as many as the launches the jobs recorded."""

from kubench.harness import spans


def read(run):
    if run.trace is None or not spans.program(run.trace):
        return None
    launches = spans.program(run.trace, spans.LAUNCH)
    recorded = sum(len(job.launches) for job in run.jobs)
    if len(launches) != recorded:
        run.note(f"{len(launches)} {spans.LAUNCH} spans in the window for {recorded} "
                 f"launches recorded; no launch_host_us read")
        return None
    if not launches:
        return None
    return sum(e - s for _, s, e in launches) / len(launches)
