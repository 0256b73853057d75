"""Core primitives: seed streams, the JSON config contract and the train
state."""

from ku_torch.core.rng import KeySeq, SeedSeq
from ku_torch.core.config import load_config, Config
from ku_torch.core.state import TrainState
