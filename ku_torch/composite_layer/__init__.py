"""Re-exports under the reference's ``ku.composite_layer`` name (port of
``ku/composite_layer/__init__.py``)."""

from ku_torch.nn.transformer import Transformer, InterferedTransformer
from ku_torch.nn.dense_composite import DenseBatchNormalization
from ku_torch.nn.attention import (
    SIMILARITY_TYPE_DIFF_ABS,
    SIMILARITY_TYPE_PLAIN,
    SIMILARITY_TYPE_SCALED,
    SIMILARITY_TYPE_GENERAL,
    SIMILARITY_TYPE_ADDITIVE,
)
