"""ku_torch: the port of ``ku`` to PyTorch and CUDA on an NVIDIA H100.

So far it holds the RBM / DBN trainer (:mod:`ku_torch.ebm`), whose CD-k run
is one launch of a hand-written Hopper kernel
(:mod:`ku_torch.kernels.cd_gibbs`), and whose data-parallel run over a
``torch.distributed`` mesh (:mod:`ku_torch.dist`) takes each step through
two hand-written step kernels with an all-reduce between them
(:mod:`ku_torch.kernels.cd_gibbs_dp`); the attention, transformer and serving
stack (:mod:`ku_torch.nn`: ``MultiHeadAttention`` with dense, paged and
int8 KV caches, ``Transformer``, the position encodings, ``generate``, the
``ContinuousBatcher`` over a dense cache or a page pool), whose prefill and
per-token reads go through hand-written kernels for flash attention and
flash decoding, dense and paged (:mod:`ku_torch.kernels.flash_attention`,
:mod:`ku_torch.kernels.decode_attention`), and whose ``use_flash``
attention trains through hand-written flash backward kernels; ``ku``'s
``Trainer`` (:mod:`ku_torch.engine_ext`); the JSON config contract and
seed streams (:mod:`ku_torch.core`); and the JSON+npz weight files and
state-dict conversion shared with ``ku`` (:mod:`ku_torch.utility`). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from ku_torch.core import config as config
from ku_torch.core import rng as rng

from ku_torch.ebm.rbm import RBM, MODE_VISIBLE_BERNOULLI, MODE_VISIBLE_GAUSSIAN, MODE_COMPLEX
from ku_torch.ebm.dbn import DBN

from ku_torch.utility import (
    save_model_jh5,
    load_model_jh5,
    params_from_numpy,
    params_to_numpy,
    state_dict_from_tree,
    tree_from_state_dict,
)

from ku_torch import dist as dist
from ku_torch import ebm as ebm
from ku_torch import engine_ext as engine_ext
from ku_torch import kernels as kernels
from ku_torch import nn as nn

__version__ = "0.1.0"
