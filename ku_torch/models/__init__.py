"""Model families (port of ``ku.models``): StyleGAN."""

from ku_torch.models.stylegan import (
    MappingNetwork,
    SynthesisNetwork,
    StyleGANGenerator,
    StyleGANDiscriminator,
    cal_num_chs,
)
