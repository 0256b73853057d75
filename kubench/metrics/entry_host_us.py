"""entry_host_us (us, lower is better; device trace), layer: the entry
points RBM.fit / DBN.fit. The mean, over the window's ``ku_torch.rbm.fit``
spans, of each span's duration less the time its ``ku_torch.cd_gibbs.launch``
child covers: the entry point's own host time (the parameters' first
draws, the rows padded and masked, the choice of trainer)."""

from kubench.harness import spans


def read(run):
    if run.trace is None:
        return None
    fits = spans.program(run.trace, spans.FIT)
    if not fits:
        return None
    launches = spans.starting_in(fits, spans.program(run.trace, spans.LAUNCH))
    own = [(e - s) - sum(min(le, e) - ls for _, ls, le in inner)
           for (_, s, e), inner in zip(fits, launches)]
    return sum(own) / len(own)
