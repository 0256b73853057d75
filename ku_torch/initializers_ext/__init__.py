"""Initializer extensions (port of ``ku.initializers_ext``)."""

from ku_torch.initializers_ext.initializers import he_normal
