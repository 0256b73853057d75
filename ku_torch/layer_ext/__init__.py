"""Re-exports under the reference's ``ku.layer_ext`` name (port of
``ku/layer_ext/__init__.py``): the layers live in :mod:`ku_torch.nn`."""

from ku_torch.nn.core import EqualizedLRDense
from ku_torch.nn.convolution import (
    EqualizedLRConv1D,
    EqualizedLRConv2D,
    EqualizedLRConv3D,
    FusedEqualizedLRConv1D,
    FusedEqualizedLRConv2D,
    FusedEqualizedLRConv3D,
    FusedEqualizedLRConv2DTranspose,
    BlurDepthwiseConv2D,
    DepthwiseConv3D,
    SeparableConv3D,
)
from ku_torch.nn.normalization import AdaptiveIN, AdaptiveINWithStyle, PixelNorm
from ku_torch.nn.style import (
    StyleMixingRegularization,
    TruncationTrick,
    MinibatchStddevConcat,
)
from ku_torch.nn.attention import (
    MultiHeadAttention,
    SIMILARITY_TYPE_DIFF_ABS,
    SIMILARITY_TYPE_PLAIN,
    SIMILARITY_TYPE_SCALED,
    SIMILARITY_TYPE_GENERAL,
    SIMILARITY_TYPE_ADDITIVE,
)
from ku_torch.nn.position_encoding import OrdinalPositionEncoding, PeriodicPositionEncoding
