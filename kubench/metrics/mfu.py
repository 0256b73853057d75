"""mfu (%, higher is better; device trace run), layer: the whole training
job. The operations of all the jobs the traced window completed (each
job's CD products and, in a stack, its transforms) over the window's
seconds, each job's at the card's dense peak in that job's own precision:
the ``peaks.json`` column its ``Job.peak`` names (TF32 for kernel #1's
3xTF32 products, bf16 for a bf16 job). A job whose column the card's row
lacks leaves the metric unread, with a note."""

NOT_FLOPS = ("match", "bytes_per_s")


def read(run):
    if run.trace is None or not run.trace.device or run.peaks is None or run.window_s <= 0:
        return None
    by_peak = run.flops_by_peak()
    unknown = sorted(p for p in by_peak if p in NOT_FLOPS or p not in run.peaks)
    if unknown:
        run.note(f"mfu: no dense peak {', '.join(unknown)} in peaks.json for "
                 f"{run.peaks['match']!r}; no mfu read")
        return None
    return sum(100.0 * flops / (run.window_s * run.peaks[p]) for p, flops in by_peak.items())
