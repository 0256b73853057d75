"""Backprop-based learning engines (port of ``ku.backprop``): the GAN
engine and the autoencoders built by encoder reversal."""

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
from ku_torch.backprop.autoencoder import (
    reverse_groups,
    reverse_model,
    reverse_specs,
    make_decoder_from_encoder,
    make_autoencoder_from_encoder,
    make_autoencoder_with_sym_sc,
    Autoencoder,
    SymSkipAutoencoder,
)
