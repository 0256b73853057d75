"""Engine extensions (port of ``ku.engine_ext``): the layer specs and
``Stack``, the structural surgery, and the ``Trainer``."""

from ku_torch.engine_ext.spec import LayerSpec, Stack, infer_shapes, spec
from ku_torch.engine_ext.training import (
    PROGRESSIVE_MODE_BACKWARD,
    PROGRESSIVE_MODE_FORWARD,
    Trainer,
    adam,
    create_prog_specs,
    glue_layers,
    merge_params,
    param_tree,
    select_params,
    train_on_batch_backward_prog_model,
    train_on_batch_forward_prog_model,
)
