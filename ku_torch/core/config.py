"""JSON config contract.

The reference drives every example from a JSON dict of conventional shape
``{mode, model_loading, hps{...}, nn_arch{...}}`` plus per-submodel blocks
(reference examples/style_based_gan/style_based_gan_conf.json:1-64,
examples/rbm/rbm_softmax_mnist_conf.json:1-23, loaded in each ``main()``,
e.g. rbm_softmax_mnist.py:145-146). We keep the same dict contract for API
parity and back it with a light attribute-access wrapper plus optional
required-key validation, instead of argparse/absl flags (the reference has
none either — its ``import argparse`` is unused).
"""

from __future__ import annotations

import json
from typing import Any, Iterable, Mapping


class Config(dict):
    """A dict with attribute access and recursive wrapping of sub-dicts.

    Behaves exactly like the raw JSON dict the reference passes around
    (``conf['hps']['lr']`` works), while also allowing ``conf.hps.lr``.
    """

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __getitem__(self, key):
        value = super().__getitem__(key)
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
            super().__setitem__(key, value)
        return value


def validate(conf: Mapping, required: Iterable[str], where: str = "config") -> None:
    """Check dotted required keys exist, e.g. ``validate(c, ['hps.lr'])``."""
    for dotted in required:
        node: Any = conf
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                raise KeyError(f"{where}: missing required key '{dotted}'")
            node = node[part]


def load_config(path: str, required: Iterable[str] = ()) -> Config:
    with open(path) as f:
        conf = Config(json.load(f))
    if required:
        validate(conf, required, where=path)
    return conf
