"""Training utilities (port of ``ku.utils``): callbacks and tracing."""

from ku_torch.utils.callbacks import (
    Callback,
    History,
    EarlyStopping,
    CheckpointCallback,
    LambdaCallback,
)
from ku_torch.utils.trace import trace, step_trace, start_profile, stop_profile
