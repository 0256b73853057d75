"""How far the f32 GAN step's gradients sit from float64 on one NVIDIA GPU,
with cuDNN's convolutions and with torch's own.

    python3 benchmarks_torch/gan_check_precision.py

The step is chip_smoke.py's phase 27 check (bench.py's StyleGAN conf,
batch 4, labels 1-3, he_scaled weights, TF32 off), taken piece by piece
(chip_smoke.gan_pieces) in float64 with torch's own convolutions, then in
f32 twice: with cuDNN and without. For each of the k + 1 updates it prints
the largest |f32 - float64| over a tensor's largest entry, and the tensor;
then the card's name and power limit as nvidia-smi gives them.
"""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def gradients(params, stats, disc_weights, conf, batches, dtype, cudnn):
    torch.backends.cudnn.enabled = cudnn
    try:
        engine = cs.gan_engine((params, stats), disc_weights, cs.DEVICE, conf, dtype=dtype)
        return cs.gan_pieces(engine, [cs.gan_on(b, cs.DEVICE, dtype) for b in batches])[2]
    finally:
        torch.backends.cudnn.enabled = True


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu, dev = torch.device("cpu"), torch.device(cs.DEVICE)
    conf = dict(cs.GAN_CONF, mixing_prob=None)
    batches = cs.gan_batches(0, 1, cs.GAN_CHECK_B, cs.GAN_CHECK_LABELS)[0]
    one = cs.gan_on(batches[0], dev)
    gen = cs.stylegan_weights(cs.StyleGANGenerator(**cs.GAN_CONF, device=cpu), seed=27)
    disc = cs.stylegan_weights(cs.StyleGANDiscriminator(**cs.GAN_DISC, device=cpu), seed=28)
    params, stats = cs.he_scaled(cs.StyleGANGenerator, conf, gen, dev, *one["z"])
    params = cs.tree_from_state_dict({k: (np.zeros_like(v) if k.endswith("noise_weight") else v)
                                      for k, v in cs._flatten(params).items()})
    disc = cs.he_scaled(cs.StyleGANDiscriminator, cs.GAN_DISC, disc, dev, one["x"], one["label"])
    ref = gradients(params, stats, disc, conf, batches, torch.float64, cudnn=False)
    for cudnn in (True, False):
        got = gradients(params, stats, disc, conf, batches, torch.float32, cudnn)
        for i, (g, w) in enumerate(zip(got, ref)):
            err, name = max((float((g[n].double() - w[n]).abs().max() / w[n].abs().max()), n)
                            for n in w if not n.endswith("noise_weight") and w[n].abs().max() > 0)
            print(f"f32 {'cuDNN' if cudnn else 'torch'} convolutions, update {i}: at most "
                  f"{err:.3e} of a tensor's largest entry off float64 ({name})", flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
