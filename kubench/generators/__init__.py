"""One module a kind of traffic mix, named by a mix's ``kind``.

A generator module has ``make(torch, config, traffic, seed, device)``,
which makes a run's inputs on ``device`` from its seed and the mix's
parameters (``kubench/traffic/<mix>.json``).
"""
