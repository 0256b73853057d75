"""Generator ``bernoulli_rows``: ``rows`` rows of binary units, each on
with probability ``density``, drawn on the device in one call (MNIST's
60,000 images have about 13 % of their pixels on). A row is as wide as the
configuration's ``visible_dim``, or the first of its ``layers``."""

from __future__ import annotations

from kubench.harness.traffic import mix


def make(torch, config: dict, traffic: dict, seed: int, device):
    """The run's rows, (rows, width) float32 0/1 on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, "rows"))
    width = config["visible_dim"] if "visible_dim" in config else config["layers"][0]
    shape = (int(traffic["rows"]), int(width))
    return (torch.rand(shape, generator=g, device=device) < float(traffic["density"])).float()
