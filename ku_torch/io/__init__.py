"""Input / output (port of ``ku.io``): checkpoints of whole train states.
``ku``'s Keras-h5 and StableHLO export modules are not ported yet."""

from ku_torch.io.checkpoint import CheckpointManager, save_train_state, restore_train_state
