"""mfu (%, higher is better; device trace run), layer: the whole training
job. The operations of all the jobs the traced window completed (each
job's CD products and, in a stack, its transforms) over the window's
seconds at the card's dense TF32 peak."""


def read(run):
    if run.trace is None or not run.trace.device or run.peaks is None or run.window_s <= 0:
        return None
    return 100.0 * sum(job.flops for job in run.jobs) / (run.window_s * run.peaks["tf32"])
