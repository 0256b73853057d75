"""ku_torch: the port of ``ku`` to PyTorch and CUDA on an NVIDIA H100.

So far it holds the RBM / DBN trainer (:mod:`ku_torch.ebm`), whose CD-k run
is one launch of a hand-written Hopper kernel
(:mod:`ku_torch.kernels.cd_gibbs`), and whose data-parallel run over a
``torch.distributed`` mesh (:mod:`ku_torch.dist`) takes each step through
two hand-written step kernels with an all-reduce between them
(:mod:`ku_torch.kernels.cd_gibbs_dp`); the attention, transformer and serving
stack (:mod:`ku_torch.nn`: ``MultiHeadAttention`` with dense, paged, ring
and int8 KV caches and int8 weights, ``Transformer``, the position
encodings, ``generate``, ``fork_cache``, ``speculative_generate``,
``beam_search``, the ``ContinuousBatcher`` over a dense cache or a page
pool, and the StyleGAN layers), whose prefill and
per-token reads go through hand-written kernels for flash attention and
flash decoding, dense and paged (:mod:`ku_torch.kernels.flash_attention`,
:mod:`ku_torch.kernels.decode_attention`), and whose ``use_flash``
attention trains through hand-written flash backward kernels; ``ku``'s
``Trainer``, with batch statistics, the layer specs and ``Stack``, and the
progressive surgery on them (:mod:`ku_torch.engine_ext`); the Dense + BN
composite and the GCN layer; the StyleGAN generator and
discriminator (:mod:`ku_torch.models`), on cuDNN's convolutions, and the GAN
engine that trains them in five composing modes, and the autoencoders made
by reversing an encoder (:mod:`ku_torch.backprop`); callbacks and tracing
(:mod:`ku_torch.utils`), checkpoints of whole train states
(:mod:`ku_torch.io`), the image utilities and a PNG codec
(:mod:`ku_torch.image_utils`);
the GAN losses and gradient penalties (:mod:`ku_torch.loss_ext`), ``MeanIoUExt``
(:mod:`ku_torch.metrics_ext`) and ``he_normal``
(:mod:`ku_torch.initializers_ext`); the NobodyConvNet backbones
(:mod:`ku_torch.applications_ext`); the backend shim and the reference's
re-export packages (:mod:`ku_torch.backend_ext`, :mod:`ku_torch.layer_ext`,
:mod:`ku_torch.composite_layer`, :mod:`ku_torch.gnn_layer`); Keras h5 weight
files and ``torch.export`` artifacts (:mod:`ku_torch.io`) and the threaded
C++ image loader (:mod:`ku_torch.native`); the JSON config contract,
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
    DenseBatchNormalization,
    GraphConvolutionNetwork,
    QuantDense,
    beam_search,
    fork_cache,
    generate,
    quantize_weights,
    speculative_generate,
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

from ku_torch import applications_ext as applications_ext
from ku_torch import backend_ext as backend_ext
from ku_torch import backprop as backprop
from ku_torch import composite_layer as composite_layer
from ku_torch import dist as dist
from ku_torch import ebm as ebm
from ku_torch import engine_ext as engine_ext
from ku_torch import gnn_layer as gnn_layer
from ku_torch import image_utils as image_utils
from ku_torch import initializers_ext as initializers_ext
from ku_torch import io as io
from ku_torch import kernels as kernels
from ku_torch import layer_ext as layer_ext
from ku_torch import loss_ext as loss_ext
from ku_torch import metrics_ext as metrics_ext
from ku_torch import models as models
from ku_torch import nn as nn
from ku_torch import utils as utils

__version__ = "0.1.0"
