"""Energy-based models: RBM and DBN (port of ``ku.ebm``)."""

from ku_torch.ebm.rbm import (
    RBM,
    RBMLayer,
    MODE_VISIBLE_BERNOULLI,
    MODE_VISIBLE_GAUSSIAN,
    MODE_COMPLEX,
    init_rbm_params,
    complex_to_stacked,
    stacked_to_complex,
    hidden_prob,
    neg_hidden_prob,
    visible_stat,
    sample_hidden,
    sample_visible,
    free_energy,
    cd_stats,
    apply_stats,
    cd_update,
    cd_epoch_scan,
    cd_epoch_scan_pcd,
    gibbs_chain,
)
from ku_torch.ebm.dbn import DBN
