"""Backprop-based learning engines (port of ``ku.backprop``): the GAN
engine."""

from ku_torch.backprop.gan import (
    STYLE_GAN_REGULAR,
    STYLE_GAN_WGAN_GP,
    STYLE_GAN_SOFTPLUS_INVERSE_R1_GP,
    LSGAN,
    PIX2PIX_GAN,
    LOSS_CONF_TYPE_NON_SATURATION_REGULAR,
    LOSS_CONF_TYPE_WGAN_GP,
    LOSS_CONF_TYPE_NON_SATURATION_SOFTPLUS_R1_GP,
    LOSS_CONF_TYPE_LS,
    AbstractGAN,
    GAN,
    compose_gan_with_mode,
    get_loss_conf,
    state_from_ku,
    state_to_ku,
)
