"""Loss extensions (port of ``ku.loss_ext``)."""

from ku_torch.loss_ext.loss import (
    EPSILON,
    CategoricalCrossentropyWithLabelGT,
    WGANLoss,
    WGANGPLoss,
    SoftPlusLoss,
    SoftPlusInverseLoss,
    RPenaltyLoss,
    categorical_crossentropy_with_label_gt,
    wgan_loss,
    wgan_gp_loss,
    softplus_loss,
    softplus_inverse_loss,
    r_penalty_loss,
    r1_penalty,
    gradient_penalty,
)
