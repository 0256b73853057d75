"""Style-based GAN on FFHQ thumbnails, in torch.

Port of ``examples/style_based_gan/style_based_gan.py``: the port's StyleGAN
generator and discriminator (``ku_torch.models``) in the port's GAN engine
(``ku_torch.backprop``), softplus-R1 by default (the conf's ``gan_mode``
2), with its conf (``examples/style_based_gan/style_based_gan_conf.json``,
read in place) and its surface:

- ``TrainingSequenceFFHQ``: PNGs under ``raw_data_path`` at the
  resolution, labels the file index modulo ``num_classes``; without
  images, synthetic smooth blobs. It draws from
  ``np.random.default_rng(seed)`` what ``ku``'s draws, in the same order,
  so the two packages see the same batches. As in ``ku``, PNGs go through
  the threaded C++ loader (``ku_torch.native``: aspect-preserving
  letterboxes), decoded in its workers when it was built with libpng, else
  decoded by ``ku_torch.image_utils.png`` and resized by the loader; where
  the loader does not build, they are read and resized by
  ``ku_torch.image_utils`` (a gray PNG taken as three equal channels). The
  sequence prints which path runs.
- ``StyleGAN``: ``train`` (one epoch at a time, a sample grid and the npz
  weights after each), ``fit_progressively`` (one stage per entry of
  ``nn_arch.gen_prog_resolutions``, the shared parameters carried by name,
  callbacks and ``initial_epoch="auto"`` as in ``fit_generator``),
  ``generate_samples``, ``evaluate`` (per-class sample grids) and
  ``main()`` over the conf's ``mode``.

``ku``'s ``lane_packing`` switch selects a TPU layout of the same function;
the port computes the unpacked function throughout, so ``ku``'s
``_infer_generate`` (an unpacked clone for large batches) is
``generate_samples`` itself. Sample grids are PNGs written by ``png.py``,
float [0, 1] pixels stored as round(255·x).

Run from the repository root: ``python examples_torch/style_based_gan/
style_based_gan.py [conf.json] [--device cpu]`` (the card by default).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples_torch import common  # noqa: E402
from ku_torch.backprop import STYLE_GAN_SOFTPLUS_INVERSE_R1_GP, AbstractGAN  # noqa: E402
from ku_torch.core.config import load_config  # noqa: E402
from ku_torch.image_utils import read_png, resize, resize_batch, write_png  # noqa: E402
from ku_torch.models import StyleGANDiscriminator, StyleGANGenerator  # noqa: E402
from ku_torch import native  # noqa: E402

CONF_PATH = os.path.join(common.KU_EXAMPLES, "style_based_gan", "style_based_gan_conf.json")


class TrainingSequenceFFHQ:
    """FFHQ thumbnail batches: real images in [-1, 1], labels the file
    index modulo ``num_classes``, latents z1 / z2, as the engine's dict
    batches (numpy arrays)."""

    def __init__(self, raw_data_path, hps, nn_arch, map_nn_arch, batch_shuffle=True, seed=0):
        self.batch_size = int(hps["batch_size"])
        self.latent_dim = int(map_nn_arch["latent_dim"])
        self.num_classes = int(map_nn_arch["num_classes"])
        self.resolution = int(nn_arch["resolution"])
        self.label_usage = bool(nn_arch.get("label_usage", True))
        self.rng = np.random.default_rng(seed)
        self.batch_shuffle = batch_shuffle
        self.files = sorted(glob.glob(os.path.join(raw_data_path, "**", "*.png"),
                                      recursive=True))
        self.synthetic = not self.files
        self._native = None
        self._native_errors_seen = 0
        if self.synthetic:
            print(f"[style_based_gan] no images under {raw_data_path!r}; "
                  "using a synthetic dataset")
        elif native.available():
            self._native = native.NativeImagePipeline(
                out_h=self.resolution, out_w=self.resolution, n_threads=4,
                capacity=4 * self.batch_size)
            print("[style_based_gan] PNGs through the native loader ("
                  + ("decoded in its workers" if self._native.supports_files()
                     else "decoded in Python, no libpng") + ")")
        else:
            print("[style_based_gan] the native loader did not build; PNGs through "
                  f"ku_torch.image_utils:\n{native.build_error()}")

    def _load_image(self, path):
        img = read_png(path).astype(np.float32) / 255.0
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        img = img[..., :3]
        if img.shape[0] != self.resolution or img.shape[1] != self.resolution:
            img = resize(img, (self.resolution, self.resolution)).numpy()
        return img * 2.0 - 1.0

    def _native_batch(self, idx):
        """The files ``idx`` through the native loader, in order."""
        if self._native.supports_files():
            for i in idx:
                self._native.submit_file(self.files[i])
            x = self._native.get_batch(len(idx))
            # A failed decode delivers a zeroed frame (order must hold):
            # say so rather than train on black images silently.
            errs = self._native.errors()
            if errs > self._native_errors_seen:
                print(f"[style_based_gan] WARNING: {errs - self._native_errors_seen} PNG "
                      f"decode failure(s) in this batch: zeroed frames entered training "
                      f"(total {errs})")
                self._native_errors_seen = errs
            return x
        for i in idx:
            raw = read_png(self.files[i])
            if raw.ndim == 2:
                raw = np.repeat(raw[..., None], 3, axis=-1)
            self._native.submit(np.ascontiguousarray(raw[..., :3]))
        return self._native.get_batch(len(idx))

    def __iter__(self):
        return self

    def __next__(self):
        b = self.batch_size
        if self.synthetic:
            # Smooth random blobs in [-1, 1].
            base = self.rng.normal(size=(b, 8, 8, 3)).astype(np.float32)
            x = np.tanh(resize_batch(base, (self.resolution, self.resolution)).numpy())
            labels = self.rng.integers(0, self.num_classes, size=(b, 1))
        else:
            idx = (self.rng.integers(0, len(self.files), size=b) if self.batch_shuffle
                   else np.arange(b) % len(self.files))
            if self._native is not None:
                x = self._native_batch(idx)
            else:
                x = np.stack([self._load_image(self.files[i]) for i in idx])
            labels = (idx % self.num_classes).reshape(-1, 1)
        z1 = self.rng.normal(size=(b, self.latent_dim)).astype(np.float32)
        z2 = self.rng.normal(size=(b, self.latent_dim)).astype(np.float32)
        batch = {"x": x.astype(np.float32)}
        if self.label_usage:
            batch["z"] = (z1, labels.astype(np.int32), z2)
            batch["label"] = labels.astype(np.float32)
        else:
            batch["z"] = (z1, z2)
        return batch


def module_confs(conf, resolution: int):
    """The generator's and the discriminator's keyword arguments at
    ``resolution`` for an example conf (its ``hps``, ``nn_arch``,
    ``map_nn_arch`` and ``disc_nn_arch``)."""
    n, h, m = conf["nn_arch"], conf["hps"], conf["map_nn_arch"]
    dtype = {"bfloat16": torch.bfloat16, "float32": None}.get(n.get("dtype"))
    lane_packing = bool(n.get("lane_packing", True))
    gen = dict(
        resolution=resolution, ch_base=int(h["ch_base"]), max_ch=int(h["max_ch"]),
        latent_dim=int(m["latent_dim"]), dlatent_dim=int(m["dlatent_dim"]),
        dense1_dim=int(m["dense1_dim"]), num_mapping_layers=int(m["num_layers"]),
        num_classes=int(m["num_classes"]), label_usage=bool(n["label_usage"]),
        mixing_prob=h.get("mixing_prob"), trunc_psi=float(h.get("trunc_psi", 0.0)),
        trunc_cutoff=h.get("trunc_cutoff"),
        trunc_momentum=float(h.get("trunc_momentum", 0.99)), dtype=dtype,
        lane_packing=lane_packing)
    disc = dict(
        resolution=resolution, ch_base=int(h["ch_base"]), max_ch=int(h["max_ch"]),
        dropout_rate=float(conf.get("disc_nn_arch", {}).get("dropout_rate", 0.0)),
        label_usage=bool(n["label_usage"]), dtype=dtype, lane_packing=lane_packing)
    return gen, disc


class StyleGAN(AbstractGAN):
    """``ku``'s example class on the port's engine. The modules of each
    resolution draw their initial parameters from ``init_seed`` and the
    resolution, on ``device``."""

    def __init__(self, conf, device="cuda", init_seed: int = 0):
        self.device_name = torch.device(device)
        self.init_seed = init_seed
        self.map_nn_arch = conf["map_nn_arch"]
        self.disc_nn_arch = conf.get("disc_nn_arch", {})
        self._nn_arch = conf["nn_arch"]
        self._hps = conf["hps"]
        conf.setdefault("hps", {})["composing_mode"] = int(
            conf.get("gan_mode", STYLE_GAN_SOFTPLUS_INVERSE_R1_GP))
        conf["nn_arch"]["gen_rng_streams"] = ["noise", "style"]
        self.raw_data_path = conf.get("raw_data_path", "")
        super().__init__(conf)

    def _modules_at(self, resolution: int):
        gen_kw, disc_kw = module_confs(self.conf, resolution)
        dev = self.device_name
        g = torch.Generator(device=dev).manual_seed(self.init_seed * 1000 + int(resolution))
        return (StyleGANGenerator(**gen_kw, device=dev, generator=g),
                StyleGANDiscriminator(**disc_kw, device=dev, generator=g))

    def _create_generator(self):
        self._pair = self._modules_at(int(self._nn_arch["resolution"]))
        return self._pair[0]

    def _create_discriminator(self):
        return self.__dict__.pop("_pair")[1]

    # -- training ------------------------------------------------------------

    def train(self, sample_dir: str = "results", save_dir: str = "."):
        """Alternating training, one epoch a ``fit_generator`` call, a
        sample grid and the npz weights after each."""
        os.makedirs(sample_dir, exist_ok=True)
        seq = TrainingSequenceFFHQ(self.raw_data_path, self._hps, self._nn_arch,
                                   self.map_nn_arch)
        self.compile()
        hist = {"disc_ext_loss": [], "gen_disc_loss": []}
        for e in range(int(self._hps["epochs"])):
            sub = dict(self.hps)
            sub["epochs"] = 1
            old, self.hps = self.hps, sub
            try:
                h = self.fit_generator(seq, verbose=1, seed=e)
            finally:
                self.hps = old
            hist["disc_ext_loss"] += h["disc_ext_loss"]
            hist["gen_disc_loss"] += h["gen_disc_loss"]
            self.save_gan_model(save_dir)
            self._dump_samples(os.path.join(sample_dir, f"epoch_{e + 1}.npy"))
        return hist

    def stage_factory(self, resolutions):
        """The progressive loop's factory: stage ``e``'s modules at its
        resolution and a fresh sequence."""

        def factory(stage, g_res, d_res):
            res = int(g_res if g_res else resolutions[-1])
            print(f"[progressive] stage {stage}: resolution {res}")
            gen, disc = self._modules_at(res)
            nn_arch_stage = dict(self._nn_arch)
            nn_arch_stage["resolution"] = res
            seq = TrainingSequenceFFHQ(self.raw_data_path, self._hps, nn_arch_stage,
                                       self.map_nn_arch)
            return gen, disc, seq

        return factory

    def fit_progressively(self, sample_dir: str = "results", callbacks=(), mesh=None,
                          initial_epoch=0):
        """One stage per entry of ``nn_arch.gen_prog_resolutions``, one
        ``fit_generator`` epoch each, the parameters that keep their names
        and shapes carried into the next stage; callbacks see the stage as
        the epoch (a ``CheckpointCallback`` saves each stage), and
        ``initial_epoch="auto"`` goes on after the last saved stage."""
        os.makedirs(sample_dir, exist_ok=True)
        self.compile()
        resolutions = self._nn_arch.get("gen_prog_resolutions",
                                        [int(self._nn_arch["resolution"])])
        sub = dict(self.hps)
        sub["epochs"] = len(resolutions)
        old, self.hps = self.hps, sub
        try:
            hist = self.fit_generator_progressively(
                self.stage_factory(resolutions), gen_prog_depths=resolutions,
                disc_prog_depths=self._nn_arch.get("disc_prog_resolutions", resolutions),
                verbose=1, seed=100, mesh=mesh, callbacks=callbacks,
                initial_epoch=initial_epoch)
        finally:
            self.hps = old
        self._dump_samples(os.path.join(sample_dir, "progressive_final.npy"))
        return hist

    def _dump_samples(self, path, n: int = 4, imgs=None):
        """A sample batch as ``.npy`` and as a PNG grid beside it."""
        if imgs is None:
            imgs = self.generate_samples(n)
        np.save(path, imgs)
        write_png(path.replace(".npy", ".png"),
                  np.concatenate(list(np.clip(imgs, 0.0, 1.0)), axis=1))

    # -- inference -------------------------------------------------------------

    def generate_samples(self, n: int, labels=None, seed: int = 0) -> np.ndarray:
        """n images in [0, 1], the latents (and labels, unless given) drawn
        from ``default_rng(seed)`` as ``ku`` draws them."""
        rng = np.random.default_rng(seed)
        m = self.map_nn_arch
        z1 = rng.normal(size=(n, int(m["latent_dim"]))).astype(np.float32)
        z2 = rng.normal(size=(n, int(m["latent_dim"]))).astype(np.float32)
        if self._nn_arch.get("label_usage", True):
            if labels is None:
                labels = rng.integers(0, int(m["num_classes"]), size=(n, 1))
            z = (z1, np.asarray(labels), z2)
        else:
            z = (z1, z2)
        img = self.generate(z, torch.Generator(device=self.device).manual_seed(seed))
        return (img.float().cpu().numpy() + 1.0) / 2.0

    def evaluate(self, result_dir: str = "results", num_per_class: int = 1, classes=(0,)):
        """Per class, ``num_per_class`` samples as ``class_<c>.npy`` and a
        PNG grid."""
        os.makedirs(result_dir, exist_ok=True)
        for c in classes:
            labels = np.full((num_per_class, 1), c)
            imgs = self.generate_samples(num_per_class, labels=labels, seed=c)
            self._dump_samples(os.path.join(result_dir, f"class_{c}.npy"), imgs=imgs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("conf", nargs="?", default=CONF_PATH)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    conf = load_config(args.conf)
    s_gan = StyleGAN(conf, device=args.device)
    start = time.time()
    if conf["mode"] == "train":
        s_gan.train()
    elif conf["mode"] == "train_progressively":
        s_gan.fit_progressively()
    elif conf["mode"] == "evaluate":
        s_gan.evaluate()
    print(f"Elasped time: {time.time() - start:f}s")


if __name__ == "__main__":
    main()
