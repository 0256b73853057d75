"""Metric extensions (port of ``ku.metrics_ext``)."""

from ku_torch.metrics_ext.metrics import MeanIoUExt
