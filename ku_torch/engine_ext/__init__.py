"""Engine extensions (port of ``ku.engine_ext``): the ``Trainer``."""

from ku_torch.engine_ext.training import Trainer, adam
