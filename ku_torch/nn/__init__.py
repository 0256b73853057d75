"""The layer zoo (port of ``ku.nn``): the StyleGAN layers, attention,
transformer blocks, position encodings and serving; only what is ported is
exported."""

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
    conv_nd,
)
from ku_torch.nn.normalization import AdaptiveIN, AdaptiveINWithStyle, PixelNorm
from ku_torch.nn.style import (
    StyleMixingRegularization,
    TruncationTrick,
    MinibatchStddevConcat,
)

from ku_torch.nn.attention import (
    MultiHeadAttention,
    apply_rope,
    SIMILARITY_TYPE_DIFF_ABS,
    SIMILARITY_TYPE_PLAIN,
    SIMILARITY_TYPE_SCALED,
    SIMILARITY_TYPE_GENERAL,
    SIMILARITY_TYPE_ADDITIVE,
)
from ku_torch.nn.transformer import Dense, LayerNorm, Transformer, InterferedTransformer
from ku_torch.nn.decoding import (
    chosen_logprob,
    generate,
    greedy,
    make_sampler,
    mask_after_eos,
)
from ku_torch.nn.serving import ContinuousBatcher
from ku_torch.nn.position_encoding import (
    OrdinalPositionEncoding,
    PeriodicPositionEncoding,
)
