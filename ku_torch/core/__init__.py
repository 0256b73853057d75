"""Core primitives: seed streams and the JSON config contract."""

from ku_torch.core.rng import SeedSeq
from ku_torch.core.config import load_config, Config
