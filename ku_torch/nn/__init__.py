"""Attention, transformer blocks, position encodings and serving (port of
that part of ``ku.nn``): only what is ported is exported."""

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
