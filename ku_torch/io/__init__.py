"""Input / output (port of ``ku.io``): checkpoints of whole train states,
Keras h5 weight files (h5py, imported where used) and ``torch.export``
artifacts."""

from ku_torch.io.checkpoint import CheckpointManager, save_train_state, restore_train_state
from ku_torch.io.export import export_fn, load_exported
from ku_torch.io.keras_h5 import (
    flax_to_keras_layers,
    graft_keras_weights,
    load_keras_h5_weights,
    load_reference_rbm_h5,
    save_keras_h5,
    save_reference_rbm_h5,
)
