"""The layer zoo (port of ``ku.nn``): the StyleGAN layers, the Dense + BN
composite, the GCN layer, attention,
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
    conv_transpose_nd,
)
from ku_torch.nn.dense_composite import BatchNorm, DenseBatchNormalization
from ku_torch.nn.gnn import GraphConvolutionNetwork
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
    beam_search,
    chosen_logprob,
    fork_cache,
    generate,
    greedy,
    make_sampler,
    mask_after_eos,
    speculative_generate,
)
from ku_torch.nn.quant import QuantDense, int8_act_matmul, quantize_weights
from ku_torch.nn.serving import ContinuousBatcher
from ku_torch.nn.position_encoding import (
    OrdinalPositionEncoding,
    PeriodicPositionEncoding,
)
