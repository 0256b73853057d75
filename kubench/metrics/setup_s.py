"""setup_s (s, lower is better; host clock): from the start of the run's
process to the start of the measured window: imports, the card's context,
loading (or, in a checkout's first run, building) the kernels, making the
rows, and the warm-up job."""


def read(run):
    return run.setup_s
