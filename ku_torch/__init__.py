"""ku_torch: the port of ``ku`` to PyTorch and CUDA on an NVIDIA H100.

So far it holds the RBM / DBN trainer (:mod:`ku_torch.ebm`), whose CD-k run
is one launch of a hand-written Hopper kernel
(:mod:`ku_torch.kernels.cd_gibbs`), and whose data-parallel run over a
``torch.distributed`` mesh (:mod:`ku_torch.dist`) takes each step through
two hand-written step kernels with an all-reduce between them
(:mod:`ku_torch.kernels.cd_gibbs_dp`); the attention, transformer and serving
stack (:mod:`ku_torch.nn`: ``MultiHeadAttention`` with dense, paged and
int8 KV caches, ``Transformer``, the position encodings, ``generate``, the
``ContinuousBatcher`` over a dense cache or a page pool, and the StyleGAN
layers), whose prefill and
per-token reads go through hand-written kernels for flash attention and
flash decoding, dense and paged (:mod:`ku_torch.kernels.flash_attention`,
:mod:`ku_torch.kernels.decode_attention`), and whose ``use_flash``
attention trains through hand-written flash backward kernels; ``ku``'s
``Trainer`` (:mod:`ku_torch.engine_ext`); the StyleGAN generator and
discriminator (:mod:`ku_torch.models`), on cuDNN's convolutions, and the GAN
engine that trains them in five composing modes (:mod:`ku_torch.backprop`);
the GAN losses and gradient penalties (:mod:`ku_torch.loss_ext`), ``MeanIoUExt``
(:mod:`ku_torch.metrics_ext`) and ``he_normal``
(:mod:`ku_torch.initializers_ext`); the JSON config contract,
seed streams and ``TrainState`` (:mod:`ku_torch.core`); and the JSON+npz weight files and
state-dict conversion shared with ``ku`` (:mod:`ku_torch.utility`). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from ku_torch.core import config as config
from ku_torch.core import rng as rng
from ku_torch.core.state import TrainState

from ku_torch.ebm.rbm import RBM, MODE_VISIBLE_BERNOULLI, MODE_VISIBLE_GAUSSIAN, MODE_COMPLEX
from ku_torch.ebm.dbn import DBN

from ku_torch.nn import (
    EqualizedLRDense,
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
    AdaptiveIN,
    AdaptiveINWithStyle,
    PixelNorm,
    StyleMixingRegularization,
    TruncationTrick,
    MinibatchStddevConcat,
    MultiHeadAttention,
    OrdinalPositionEncoding,
    PeriodicPositionEncoding,
    Transformer,
    InterferedTransformer,
)

from ku_torch.utility import (
    save_model_jh5,
    load_model_jh5,
    params_from_numpy,
    params_to_numpy,
    state_dict_from_tree,
    tree_from_state_dict,
    variables_from_module,
)

from ku_torch.backprop import (
    STYLE_GAN_REGULAR,
    STYLE_GAN_WGAN_GP,
    STYLE_GAN_SOFTPLUS_INVERSE_R1_GP,
    LSGAN,
    PIX2PIX_GAN,
    AbstractGAN,
    GAN,
    compose_gan_with_mode,
    get_loss_conf,
)

from ku_torch import backprop as backprop
from ku_torch import dist as dist
from ku_torch import ebm as ebm
from ku_torch import engine_ext as engine_ext
from ku_torch import initializers_ext as initializers_ext
from ku_torch import kernels as kernels
from ku_torch import loss_ext as loss_ext
from ku_torch import metrics_ext as metrics_ext
from ku_torch import models as models
from ku_torch import nn as nn

__version__ = "0.1.0"
