"""transform_device_ms (ms, lower is better; device trace), layer: the
entry points (a stacked RBM's transform). Per job, the device time of the
operations launched from inside the window's ``ku_torch.rbm.transform``
spans, each operation tied to the host call that launched it by the
trace's own link (its correlation, or its External id)."""

from kubench.harness import spans


def read(run):
    trace = run.trace
    if trace is None or not trace.jobs:
        return None
    transforms = spans.program(trace, spans.TRANSFORM)
    if not transforms:
        return None
    links = spans.run_links(run)
    if links is None:
        return None
    ops = spans.launched_in(links, transforms)
    if not ops:
        run.note(f"no device operation linked to the {len(transforms)} {spans.TRANSFORM} "
                 f"spans; no transform_device_ms read")
        return None
    return sum(e - s for _, s, e, _ in ops) / len(trace.jobs) / 1e3
