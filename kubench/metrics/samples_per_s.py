"""samples_per_s (samples/s, higher is better; host clock): all the
training examples of all the jobs of the window, over the window's wall
time from its start to the card's completion of its last job. A row
through one CD epoch of one RBM counts one: a DBN job counts rows x epochs
x layers."""


def read(run):
    if not run.jobs or run.window_s <= 0:
        return None
    return sum(job.samples for job in run.jobs) / run.window_s
