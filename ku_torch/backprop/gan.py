"""GAN training engine (port of ``ku/backprop/gan.py``): five composing
modes, k discriminator updates then one generator update a step.

What ``ku`` does, and how the port does it:

- "Which model trains" is which parameters get the gradient: a D step
  differentiates the mode's discriminator loss in the discriminator's
  parameters only (``torch.autograd.grad``), a G step the generator loss in
  the generator's parameters only. The modules own the parameters; each
  side's :class:`~ku_torch.core.state.TrainState` holds them with its
  ``torch.optim.Adam`` (``ku_torch.engine_ext.adam``, optax's formula).
- R1 and WGAN-GP are input gradients taken with ``create_graph=True``
  (``ku_torch.loss_ext.input_grad``) and differentiated again.
- A step is ``disc_k_step`` D updates, then one G update on a *fresh*
  (k+1)-th batch. ``ku`` runs it as one jitted function; here it is a
  sequence of torch calls on the modules' device.
- Random draws (the generator's noise and style mixing, WGAN-GP's ε) come
  from one ``torch.Generator`` on that device, which both train states
  hold; they cannot match JAX's. The generator gets it as ``generator=``
  when ``nn_arch.gen_rng_streams`` is non-empty, as ``ku`` then passes
  rngs. The discriminator is called as ``ku`` calls it, with no draws.

Where a literal translation of ``ku``'s step would compute another
function:

- ``ku`` generates the D steps' fakes in training mode and throws away the
  updated ``batch_stats`` (``gan.py:346-350``). The port's modules update
  their buffers in place (``TruncationTrick.moving_mean``), so each fake is
  made under :func:`_buffers_kept`: it is truncated toward that call's
  updated mean, and the buffers after the D steps are those before them.
- ``ku`` vmaps the generator over the k D batches (``:528-534``): each slice
  takes its own truncation batch mean and its own noise field. Here they
  are k generator calls, never one call over k·B rows.
- ``ku`` vmaps the discriminator over [real; fake] (``:397-402``), so the
  minibatch-stddev groups never mix real and fake rows. Here D(real) and
  D(fake) are two calls, never one over 2B rows.
- ``ku``'s memory and speed knobs, ``remat`` / ``remat_gen`` /
  ``remat_disc`` (rematerialisation policies) and ``r1_fused_vjp`` (R1's
  input gradient from D(real)'s own forward), change what is recomputed,
  never the values. The conf keys are accepted and the port computes the
  same function without them (ROADMAP.md §3).

``mesh=`` (a ``DeviceMesh``, :func:`ku_torch.dist.make_mesh`; every rank
calls the engine alike, with the same batches) trains over the mesh as
``ku``'s GSPMD step does, computing the single-device step's function:

- a ``"data"`` axis splits each batch's rows (``ku``'s
  ``shard_stacked_batches``): each rank takes its slice, the loss means are
  weighted so that the all-reduced gradients are the whole batch's, the
  batch statistics (truncation's batch mean, the minibatch-stddev groups,
  which straddle the ranks) are the whole batch's
  (:func:`ku_torch.dist.parallel.data_parallel`), and WGAN-GP's ε is drawn
  for the whole batch and sliced; the generator's draws (its noise field
  and style mixing) do not depend on the batch's rows, so the ranks draw
  them alike from the same generator;
- a ``"model"`` axis splits by column the kernels that ``ku``'s
  ``shard_gan_state`` splits (2-D ``kernel`` leaves under ``map_dense``,
  ``style_dense`` or ``dense_1`` whose columns divide): each rank holds and
  updates its columns (Adam on a slice is the slice of Adam), computes them
  and all-gathers the features (:func:`ku_torch.dist.parallel
  .shard_columns_`, in place on the modules).

Under a model axis past 1, the modules hold their ranks' columns: saving or
exporting them saves slices.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ku_torch.core.state import TrainState
from ku_torch.dist.mesh import axis_info, check_mesh, shard_batch
from ku_torch.dist.parallel import data_parallel, shard_columns_
from ku_torch.engine_ext.training import adam
from ku_torch.loss_ext.loss import (
    input_grad,
    lsgan_loss,
    r_penalty_loss,
    softplus_inverse_loss,
    softplus_loss,
    wgan_gp_loss,
    wgan_loss,
)
from ku_torch.utility import (
    load_weights,
    save_weights,
    state_dict_from_tree,
    tree_from_state_dict,
    variables_from_module,
)

# GAN mode (reference gan.py:31-35).
STYLE_GAN_REGULAR = 0
STYLE_GAN_WGAN_GP = 1
STYLE_GAN_SOFTPLUS_INVERSE_R1_GP = 2
LSGAN = 3
PIX2PIX_GAN = 4

# Loss configuration type (reference gan.py:38-41).
LOSS_CONF_TYPE_NON_SATURATION_REGULAR = 0
LOSS_CONF_TYPE_WGAN_GP = 1
LOSS_CONF_TYPE_NON_SATURATION_SOFTPLUS_R1_GP = 2
LOSS_CONF_TYPE_LS = 3


def _bce_logits(y_true, y_pred):
    """BinaryCrossentropy(from_logits=True) per sample."""
    return (y_pred.clamp_min(0.0) - y_pred * y_true
            + torch.log1p(torch.exp(-y_pred.abs()))).mean(dim=-1)


def get_loss_conf(hps: Dict, lc_type: int, **kwargs) -> Dict:
    """Per-mode loss lists and weights (``ku``'s contract):
    ``disc_ext_losses`` apply to [D(x), (R1/GP head), D(G(z))] in order,
    ``gen_disc_losses`` to [D(G(z))]; the penalties are the tagged tuples
    ``('r1', γ)`` and ``('gp', λ, target)``."""
    if lc_type == LOSS_CONF_TYPE_NON_SATURATION_REGULAR:
        return {
            "disc_ext_losses": [_bce_logits, _bce_logits],
            "disc_ext_loss_weights": [1.0, 1.0],
            "gen_disc_losses": [_bce_logits],
            "gen_disc_loss_weights": [1.0],
        }
    if lc_type == LOSS_CONF_TYPE_WGAN_GP:
        return {
            "disc_ext_losses": [
                wgan_loss,
                wgan_loss,
                ("gp", hps.get("wgan_lambda", 10.0), hps.get("wgan_target", 1.0)),
            ],
            "disc_ext_loss_weights": [-1.0, 1.0, 1.0],
            "gen_disc_losses": [wgan_loss],
            "gen_disc_loss_weights": [-1.0],
        }
    if lc_type == LOSS_CONF_TYPE_NON_SATURATION_SOFTPLUS_R1_GP:
        return {
            "disc_ext_losses": [
                softplus_inverse_loss,
                ("r1", hps.get("r_gamma", 10.0)),
                softplus_loss,
            ],
            "disc_ext_loss_weights": [1.0, 1.0, 1.0],
            "gen_disc_losses": [softplus_inverse_loss],
            "gen_disc_loss_weights": [1.0],
        }
    if lc_type == LOSS_CONF_TYPE_LS:
        return {
            "disc_ext_losses": [lsgan_loss, lsgan_loss],
            "disc_ext_loss_weights": [1.0, 1.0],
            "gen_disc_losses": [lsgan_loss],
            "gen_disc_loss_weights": [1.0],
        }
    raise ValueError("type is not valid.")


_MODE_TO_LC = {
    STYLE_GAN_REGULAR: LOSS_CONF_TYPE_NON_SATURATION_REGULAR,
    STYLE_GAN_WGAN_GP: LOSS_CONF_TYPE_WGAN_GP,
    STYLE_GAN_SOFTPLUS_INVERSE_R1_GP: LOSS_CONF_TYPE_NON_SATURATION_SOFTPLUS_R1_GP,
    LSGAN: LOSS_CONF_TYPE_LS,
    PIX2PIX_GAN: LOSS_CONF_TYPE_NON_SATURATION_REGULAR,
}


def _to_device(tree, device):
    """A batch (dicts, tuples and lists of arrays or tensors) on ``device``."""
    if isinstance(tree, Mapping):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.as_tensor(np.asarray(tree), device=device)


@contextlib.contextmanager
def _buffers_kept(module):
    """Run the body, then put the module's buffers back as they were (ku
    drops a call's updated ``batch_stats``)."""
    values = [b.detach().clone() for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in zip(module.buffers(), values, strict=True):
                b.copy_(v)


def _load_tree(module, params, stats=None):
    """Load ``ku``'s nested ``params`` (and ``stats``, its ``batch_stats``)
    into ``module``, strictly; without ``stats`` the module keeps its
    buffers."""
    device = next(module.parameters()).device
    sd = state_dict_from_tree(params, device, batch_stats=stats)
    if stats is None:
        names = {n for n, _ in module.named_parameters()}
        sd.update({k: v for k, v in module.state_dict().items() if k not in names})
    module.load_state_dict(sd, strict=True)


class AbstractGAN:
    """GAN engine with ``ku``'s surface: ``compose_gan_with_mode`` →
    :meth:`compile`; :meth:`fit_generator`;
    :meth:`fit_generator_progressively`; :meth:`evaluate`;
    :meth:`generate`; :meth:`save_gan_model` / :meth:`load_gan_model`.

    - ``gen``: a torch module called as ``gen(z, deterministic=...)`` (plus
      ``generator=`` with ``gen_rng_streams``) → the fake sample, or a
      tuple whose first entry is. Its buffers are its ``batch_stats``.
    - ``disc``: a torch module called as ``disc(x)``, ``disc((x,
      label))`` when the batch has a ``'label'``, or ``disc((cond, x))``
      for pix2pix → logits.
    - Data: an iterator of dict batches with ``'x'`` (real), ``'z'`` (the
      generator's input, a tensor or a tuple), optionally ``'label'``,
      ``'cond'`` and ``'x_target'`` (pix2pix's L1 target), as numpy
      arrays or tensors; they go to the modules' device.

    The conf dict is ``ku``'s (``{hps{...}, nn_arch{...}, ...}``).
    ``self.state`` is ``{"gen": TrainState, "disc": TrainState}``, the two
    sharing one ``torch.Generator``; the GAN's step count is the
    generator's (one G update a step).
    """

    GEN_DISC_PATH = "gen_disc"
    DISC_EXT_PATH = "disc_ext"

    def __init__(self, conf, gen=None, disc=None):
        self.conf = conf
        self.hps = dict(conf.get("hps", {}))
        self.nn_arch = dict(conf.get("nn_arch", {}))
        self.composing_mode = int(
            self.hps.get("composing_mode", STYLE_GAN_SOFTPLUS_INVERSE_R1_GP))
        self.gen = gen if gen is not None else self._create_generator()
        self.disc = disc if disc is not None else self._create_discriminator()
        self.gen_rng_streams = tuple(self.nn_arch.get("gen_rng_streams", ()))
        self.state = None
        self._compiled = False
        # The mesh of the last fit: its "data" axis's (group, size, rank),
        # and the pair of modules its "model" axis split.
        self._mesh = self._dp = self._split = None
        if conf.get("model_loading"):
            self.load_gan_model()

    # Subclass hooks, as in ku.
    def _create_generator(self):
        raise NotImplementedError

    def _create_discriminator(self):
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return next(self.gen.parameters()).device

    # -- composition / compilation -----------------------------------------

    def compose_gan_with_mode(self, mode: Optional[int] = None):
        """Record the composing mode; it selects the loss graph."""
        if mode is not None:
            self.composing_mode = mode
        self.loss_conf = get_loss_conf(self.hps, _MODE_TO_LC[self.composing_mode])
        return self

    def compile(self, disc_ext_opt: Optional[Callable] = None,
                gen_disc_opt: Optional[Callable] = None, loss_conf=None):
        """Set the optimizer factories (``params -> Optimizer``): by default
        Adam at ``disc_ext_hps`` / ``gen_disc_hps``'s ``lr`` (1e-4 / 1e-3),
        ``beta_1`` (0) and ``beta_2`` (0.99), looked up under ``hps`` or at
        the conf's top level. A state loaded before compiling gets its
        optimizers here."""
        if not hasattr(self, "loss_conf") or loss_conf is not None:
            self.loss_conf = loss_conf or get_loss_conf(
                self.hps, _MODE_TO_LC[self.composing_mode])
        d_hps = self.hps.get("disc_ext_hps", self.conf.get("disc_ext_hps", self.hps))
        g_hps = self.hps.get("gen_disc_hps", self.conf.get("gen_disc_hps", self.hps))
        self.disc_opt = disc_ext_opt if disc_ext_opt is not None else adam(
            d_hps.get("lr", 1e-4), b1=d_hps.get("beta_1", 0.0),
            b2=d_hps.get("beta_2", 0.99))
        self.gen_opt = gen_disc_opt if gen_disc_opt is not None else adam(
            g_hps.get("lr", 1e-3), b1=g_hps.get("beta_1", 0.0),
            b2=g_hps.get("beta_2", 0.99))
        if self.state is not None:
            for side, tx in (("gen", self.gen_opt), ("disc", self.disc_opt)):
                st = self.state[side]
                if st.optimizer is None:
                    st.optimizer = tx(st.params)
        self._compiled = True
        return self

    def _new_state(self, seed: int, optimizers: bool):
        draws = torch.Generator(device=self.device).manual_seed(seed)

        def side(module, tx):
            if optimizers:
                return TrainState.create(module.parameters(), tx, draws)
            return TrainState(module.parameters(), None, draws)

        return {"gen": side(self.gen, getattr(self, "gen_opt", None)),
                "disc": side(self.disc, getattr(self, "disc_opt", None))}

    def init_state(self, sample_batch=None, seed: int = 0):
        """Both sides' optimizer states at step 0, and the draws seeded with
        ``seed``. The modules hold their parameters from construction (ku
        initialises them here from ``sample_batch``, which is not needed)."""
        if not self._compiled:
            self.compile()
        self.state = self._new_state(seed, optimizers=True)
        return self

    # -- apply helpers ------------------------------------------------------

    def _gen_output_image(self, fake):
        """Generators may return (image, aux...); the image feeds D."""
        return fake[0] if isinstance(fake, (tuple, list)) else fake

    def _gen_apply(self, z, generator, train: bool):
        kw = {"generator": generator} if self.gen_rng_streams else {}
        return self.gen(z, deterministic=not train, **kw)

    def _disc_input(self, batch, x):
        if self.composing_mode == PIX2PIX_GAN:
            return (batch["cond"], x)
        if "label" in batch:
            return (x, batch["label"])
        return x

    # -- the alternating step -----------------------------------------------

    def _gen_fake(self, batch, generator):
        """The fake batch for a D step: the generator in training mode, no
        gradient, its buffers as they were before the call."""
        with torch.no_grad(), _buffers_kept(self.gen):
            return self._gen_output_image(self._gen_apply(batch["z"], generator, train=True))

    def _gen_fakes(self, batches, generator):
        """The D steps' fakes, one generator call a batch: ``ku`` vmaps over
        the batches, so each takes its own truncation batch mean and noise
        field, which one call over all their rows would not."""
        return [self._gen_fake(b, generator) for b in batches]

    def _interp_eps(self, x_real, generator):
        """WGAN-GP's interpolation weights, U[0, 1) per sample (drawn for the
        whole batch and sliced to this rank's rows under a data axis)."""
        n, dp = x_real.shape[0], self._dp
        rows = n if dp is None else n * dp[1]
        shape = (rows,) + (1,) * (x_real.dim() - 1)
        eps = torch.rand(shape, generator=generator, device=x_real.device,
                         dtype=x_real.dtype)
        return eps if dp is None else eps[dp[2] * n:(dp[2] + 1) * n]

    def _disc_loss(self, batch, generator, fake=None, lazy_r1: bool = True):
        """The mode's discriminator loss (one D step). ``fake``: the D
        step's fake batch, made here when absent (evaluation).
        ``lazy_r1=False`` takes the R1 penalty every call, whatever
        ``hps['r1_interval']`` and the step."""
        lc = self.loss_conf
        losses = lc["disc_ext_losses"]
        weights = lc["disc_ext_loss_weights"]
        mode = self.composing_mode

        if fake is None:
            fake = self._gen_fake(batch, generator)
        x_real = batch["x"]

        def d_of(x):
            return self.disc(self._disc_input(batch, x))

        interval = int(self.hps.get("r1_interval", 1)) if lazy_r1 else 1
        d_real = d_of(x_real)
        d_fake = d_of(fake)
        ones = torch.ones_like(d_real)
        zeros = torch.zeros_like(d_fake)

        if mode in (STYLE_GAN_REGULAR, LSGAN, PIX2PIX_GAN):
            total = (weights[0] * losses[0](ones, d_real).mean()
                     + weights[1] * losses[1](zeros, d_fake).mean())
        elif mode == STYLE_GAN_WGAN_GP:
            eps = self._interp_eps(x_real, generator)
            grads = input_grad(d_of, eps * x_real + (1.0 - eps) * fake)
            _, lam, target = losses[2]
            total = (weights[0] * losses[0](ones, d_real).mean()
                     + weights[1] * losses[1](zeros, d_fake).mean()
                     + weights[2] * wgan_gp_loss(grads, lam, target).mean())
        elif mode == STYLE_GAN_SOFTPLUS_INVERSE_R1_GP:
            _, r_gamma = losses[1]
            if interval == 1 or self.state["gen"].step % interval == 0:
                # Lazy regularization (StyleGAN2 §B): the penalty every
                # `r1_interval` steps, scaled by the interval.
                r1 = r_penalty_loss(input_grad(d_of, x_real), r_gamma).mean() * float(
                    interval)
            else:
                r1 = torch.zeros((), dtype=d_real.dtype, device=d_real.device)
            total = (weights[0] * losses[0](ones, d_real).mean()
                     + weights[1] * r1
                     + weights[2] * losses[2](zeros, d_fake).mean())
        else:
            raise ValueError("mode is not valid.")
        return total

    def _gen_loss(self, batch, generator):
        """The mode's generator loss; the generator's forward updates its
        buffers."""
        lc = self.loss_conf
        losses = lc["gen_disc_losses"]
        weights = lc["gen_disc_loss_weights"]
        fake = self._gen_output_image(self._gen_apply(batch["z"], generator, train=True))
        d_fake = self.disc(self._disc_input(batch, fake))
        total = weights[0] * losses[0](torch.ones_like(d_fake), d_fake).mean()
        if self.composing_mode == PIX2PIX_GAN:
            # L1 reconstruction on G(z) against 'x_target', else the real 'x'.
            l1_w = self.hps.get("pix2pix_l1_weight", 100.0)
            l1_target = batch["x_target"] if "x_target" in batch else batch["x"]
            total = total + l1_w * (fake - l1_target).abs().mean()
        return total

    def _update(self, state: TrainState, loss):
        """One optimizer step on ``loss``'s gradients; under a data axis,
        this rank's part of the loss (local means over 1/W of the rows), so
        the gradients are summed over the ranks and divided by W."""
        grads = torch.autograd.grad(loss, state.params, allow_unused=True,
                                    materialize_grads=True)
        if self._dp is not None:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self._dp[0])
            flat = flat / self._dp[1]
            grads = [part.view_as(g) for part, g in
                     zip(flat.split([g.numel() for g in grads]), grads)]
        state.apply_gradients(grads)

    def _mean_loss(self, loss):
        """The whole batch's loss from this rank's part (for the logs)."""
        if self._dp is None:
            return loss
        loss = loss.clone()
        dist.all_reduce(loss, group=self._dp[0])
        return loss / self._dp[1]

    def train_step(self, batches: Sequence[Mapping], disc_k_step: int):
        """k = ``disc_k_step`` D updates, then one G update (``ku``'s
        ``_train_step_inner``). ``batches``: k + 1 batches; the first k feed
        the D updates, the last a fresh one the G update. All k fakes are
        made before the first D update (the generator does not change
        during them), one generator call each. Returns the (k,) D losses and
        the G loss, on the device."""
        batches = [self._rows(_to_device(b, self.device)) for b in batches[:disc_k_step + 1]]
        draws = self.state["gen"].generator
        with data_parallel(None if self._dp is None else self._dp[0]):
            fakes = self._gen_fakes(batches[:disc_k_step], draws)
            d_losses = []
            for batch, fake in zip(batches[:disc_k_step], fakes):
                loss = self._disc_loss(batch, draws, fake)
                self._update(self.state["disc"], loss)
                d_losses.append(self._mean_loss(loss.detach()))
            g_loss = self._gen_loss(batches[disc_k_step], draws)
            self._update(self.state["gen"], g_loss)
        return torch.stack(d_losses), self._mean_loss(g_loss.detach())

    def _rows(self, batch):
        """This rank's rows of a batch under a data axis (``ku``'s
        ``shard_stacked_batches``: the batch axis of each stacked leaf)."""
        if self._dp is None:
            return batch
        return shard_batch(self._mesh, batch, axis=0, axis_name="data")

    def _place(self, mesh):
        """Train over ``mesh`` from here on: its ``"data"`` axis splits the
        batches; its ``"model"`` axis splits the modules' kernels by column
        (once per pair of modules), a state built before keeping its Adam
        moments, sliced like their parameters."""
        names = check_mesh(mesh).mesh_dim_names
        self._mesh = mesh
        self._dp = axis_info(mesh, "data") if "data" in names else None
        if self._dp is not None and self._dp[1] == 1:
            self._dp = None  # one rank: nothing to split or to sum
        modules = (id(self.gen), id(self.disc))
        if "model" not in names or self._split == modules:
            return
        split = shard_columns_(self.gen, mesh) + shard_columns_(self.disc, mesh)
        self._split = modules
        for st in (self.state or {}).values():
            for p, cut in split:
                for key, value in st.optimizer.state.get(p, {}).items():
                    if value.dim():
                        st.optimizer.state[p][key] = cut(value)

    def train_multi_step(self, groups: Sequence[Sequence[Mapping]], disc_k_step: int):
        """``len(groups)`` steps in one call (``ku``'s ``steps_per_call``);
        the losses stacked (S, k) and (S,)."""
        d_losses, g_losses = zip(*(self.train_step(b, disc_k_step) for b in groups))
        return torch.stack(d_losses), torch.stack(g_losses)

    # -- training loops -----------------------------------------------------

    def fit_generator(self, generator, verbose: int = 1, seed: int = 0,
                      mesh=None, callbacks=(), initial_epoch=0):
        """Alternating training from a batch iterator (``ku``'s contract):
        ``hps`` ``epochs``, ``batch_step`` (steps an epoch), ``disc_k_step``
        and ``steps_per_call`` (steps between two reads of the losses);
        each step takes ``disc_k_step + 1`` batches. The draws restart from
        ``seed``. Callbacks: ``on_train_begin(engine)``,
        ``on_train_batch_end(engine, step, logs)`` where present,
        ``on_epoch_end(engine, epoch, logs)``, ``on_train_end(engine,
        history)``; ``initial_epoch="auto"`` resumes after the epoch that a
        callback's ``maybe_restore(engine)`` returns; ``engine.stop_training``
        ends the run after the epoch. Returns ``{"disc_ext_loss": [...],
        "gen_disc_loss": [...]}``, one mean an epoch."""
        epochs = int(self.hps.get("epochs", 1))
        batch_step = int(self.hps.get("batch_step", 1))
        disc_k_step = int(self.hps.get("disc_k_step", 1))
        steps_per_call = max(1, int(self.hps.get("steps_per_call", 1)))
        if not self._compiled:
            self.compile()
        self._dp = None  # a data axis splits only the fits given its mesh
        if mesh is not None:
            self._place(mesh)
        if self.state is None:
            self.init_state(seed=seed)
        else:
            self.state["gen"].generator.manual_seed(seed)
        it = iter(generator)

        for cb in callbacks:
            cb.on_train_begin(self)
        if initial_epoch == "auto":
            initial_epoch = 0
            for cb in callbacks:
                if hasattr(cb, "maybe_restore"):
                    restored = cb.maybe_restore(self)
                    if restored is not None:
                        initial_epoch = max(initial_epoch, restored + 1)
        initial_epoch = int(initial_epoch)
        history = {"disc_ext_loss": [], "gen_disc_loss": []}
        self.stop_training = False
        for e in range(initial_epoch, epochs):
            d_losses, g_losses = [], []
            s = 0
            while s < batch_step:
                n_fused = min(steps_per_call, batch_step - s)
                groups = [[next(it) for _ in range(disc_k_step + 1)]
                          for _ in range(n_fused)]
                d_loss, g_loss = self.train_multi_step(groups, disc_k_step)
                step_logs = [{"disc_ext_loss": d, "gen_disc_loss": g} for d, g in zip(
                    d_loss.mean(dim=1).tolist(), g_loss.tolist())]
                for i, logs_i in enumerate(step_logs):
                    d_losses.append(logs_i["disc_ext_loss"])
                    g_losses.append(logs_i["gen_disc_loss"])
                    for cb in callbacks:
                        if hasattr(cb, "on_train_batch_end"):
                            cb.on_train_batch_end(self, s + i, logs_i)
                s += n_fused
            history["disc_ext_loss"].append(float(np.mean(d_losses)))
            history["gen_disc_loss"].append(float(np.mean(g_losses)))
            if verbose:
                print(
                    f"Epoch {e + 1}/{epochs}, disc_ext loss: "
                    f"{history['disc_ext_loss'][-1]:f}, gen_disc loss: "
                    f"{history['gen_disc_loss'][-1]:f}"
                )
            logs = {"disc_ext_loss": history["disc_ext_loss"][-1],
                    "gen_disc_loss": history["gen_disc_loss"][-1]}
            for cb in callbacks:
                cb.on_epoch_end(self, e, logs)
            if self.stop_training:
                break
        for cb in callbacks:
            cb.on_train_end(self, history)
        return history

    def checkpoint_tree(self):
        """What a checkpoint of the engine holds (``ku_torch.utils
        .CheckpointCallback``): both train states, so the parameters, the Adam
        moments, the steps and the draws' generator, and the modules' buffers
        (``ku``'s ``gen_stats`` / ``disc_stats``). Restoring into it writes the
        live tensors in place."""
        return {"state": self.state,
                "buffers": {"gen": dict(self.gen.named_buffers()),
                            "disc": dict(self.disc.named_buffers())}}

    def _param_trees(self):
        """Both modules' parameters as ``ku``'s trees, the kernels that a
        model axis split all-gathered whole."""
        return {"gen_params": _whole_params(self.gen),
                "disc_params": _whole_params(self.disc)}

    def _prog_stage_setup(self, e: int, generator_factory, gen_prog_depths,
                          disc_prog_depths, seed: int, prev_params=None, mesh=None):
        """Build stage ``e``'s modules and iterator, a fresh state at the new
        depth, and seed the parameters whose names and shapes the previous
        stage shares from ``prev_params`` (before training, so that the
        stage learns from them)."""
        g_d = gen_prog_depths[e] if e < len(gen_prog_depths) else None
        d_d = disc_prog_depths[e] if e < len(disc_prog_depths) else None
        self.gen, self.disc, it = generator_factory(e, g_d, d_d)
        if prev_params is not None:
            _load_tree(self.gen, _merge_shared(
                variables_from_module(self.gen)["params"], prev_params["gen_params"]))
            _load_tree(self.disc, _merge_shared(
                variables_from_module(self.disc)["params"], prev_params["disc_params"]))
        self.state = None
        if mesh is not None:
            if not self._compiled:
                self.compile()
            self._place(mesh)  # the new modules split before their state
        self.init_state(seed=seed + e)
        return iter(it)

    def fit_generator_progressively(self, generator_factory,
                                    gen_prog_depths: Sequence[int] = (),
                                    disc_prog_depths: Sequence[int] = (),
                                    verbose: int = 1, seed: int = 0,
                                    mesh=None, callbacks=(),
                                    initial_epoch=0):
        """Progressive training: each scheduled epoch ``e`` rebuilds the
        modules through ``generator_factory(e, gen_depth, disc_depth)`` →
        (gen, disc, batch iterator), carries the parameters that keep their
        names and shapes, and trains one epoch through
        :meth:`fit_generator` with the global epoch index (callbacks see
        the stage). ``initial_epoch="auto"`` rebuilds the latest
        checkpointed stage (a callback's ``mgr.latest_step()``), restores
        it and goes on at the next. Returns one history a stage."""
        if mesh is not None:
            check_mesh(mesh)
        epochs = int(self.hps.get("epochs", 1))
        history = []
        prev_params = self._param_trees() if self.state is not None else None

        if initial_epoch == "auto":
            initial_epoch = 0
            ckpt = next((cb for cb in callbacks if hasattr(cb, "maybe_restore")), None)
            latest = (ckpt.mgr.latest_step()
                      if ckpt is not None and hasattr(ckpt, "mgr") else None)
            if latest is not None and latest < epochs:
                self._prog_stage_setup(int(latest), generator_factory, gen_prog_depths,
                                       disc_prog_depths, seed, prev_params, mesh)
                restored = ckpt.maybe_restore(self)
                if restored is not None:
                    prev_params = self._param_trees()
                    initial_epoch = int(restored) + 1
        initial_epoch = int(initial_epoch)

        for e in range(initial_epoch, epochs):
            it = self._prog_stage_setup(e, generator_factory, gen_prog_depths,
                                        disc_prog_depths, seed, prev_params, mesh)
            sub_hps = dict(self.hps)
            sub_hps["epochs"] = e + 1
            old_hps, self.hps = self.hps, sub_hps
            try:
                h = self.fit_generator(it, verbose=verbose, seed=seed + e, mesh=mesh,
                                       callbacks=callbacks, initial_epoch=e)
            finally:
                self.hps = old_hps
            prev_params = self._param_trees()
            history.append(h)
        return history

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, generator, steps: int = 1, seed: int = 0,
                 steps_per_call: int = 32):
        """Mean D and G losses over ``steps`` batches, with no update: the
        parameters, the buffers and the state's draws stay as they are. R1
        is taken every batch, whatever ``r1_interval``. The draws come from
        ``seed``; the losses reach the host every ``steps_per_call``
        batches. Needs a state (it will not initialise one from an eval
        batch)."""
        if self.state is None:
            raise RuntimeError(
                "evaluate() requires initialized state — call init_state/"
                "load_gan_model/fit_generator first (refusing to silently "
                "initialize parameters from an eval batch)")
        it = iter(generator)
        draws = torch.Generator(device=self.device).manual_seed(seed)
        d_all, g_all, chunk = [], [], []
        with _buffers_kept(self.gen):
            for i in range(steps):
                batch = _to_device(next(it), self.device)
                d = self._disc_loss(batch, draws, lazy_r1=False).detach()
                with torch.no_grad():
                    g = self._gen_loss(batch, draws)
                chunk.append(torch.stack([d, g]))
                if len(chunk) == steps_per_call or i == steps - 1:
                    for d_i, g_i in torch.stack(chunk).tolist():
                        d_all.append(d_i)
                        g_all.append(g_i)
                    chunk = []
        return {"disc_ext_loss": float(np.mean(d_all)),
                "gen_disc_loss": float(np.mean(g_all))}

    # -- inference / persistence -------------------------------------------

    def generate(self, z, generator: Optional[torch.Generator] = None):
        """Samples from ``z``: ``deterministic=True``, no gradient, no
        buffer update."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        with torch.no_grad():
            out = self._gen_apply(_to_device(z, self.device), generator, train=False)
        return self._gen_output_image(out)

    def save_gan_model(self, path: str = "."):
        """Both modules' ``{"params", "stats"}`` as ``ku``'s npz pairs
        (``gen_disc.npz``, ``disc_ext.npz``); each package reads the
        other's."""
        for module, name in ((self.gen, self.GEN_DISC_PATH), (self.disc, self.DISC_EXT_PATH)):
            v = variables_from_module(module)
            save_weights({"params": v["params"], "stats": v["batch_stats"]},
                         os.path.join(path, name))

    def load_gan_model(self, path: str = "."):
        """Load the npz pairs. Without a state it loads the params and the
        stats and builds the state (with optimizers once compiled); with one
        it loads the params only, as ``ku`` does."""
        g = load_weights(os.path.join(path, self.GEN_DISC_PATH))
        d = load_weights(os.path.join(path, self.DISC_EXT_PATH))
        if self.state is None:
            _load_tree(self.gen, g["params"], g.get("stats", {}))
            _load_tree(self.disc, d["params"], d.get("stats", {}))
            self.state = self._new_state(0, optimizers=self._compiled)
        else:
            _load_tree(self.gen, g["params"])
            _load_tree(self.disc, d["params"])
        return self


def _whole_params(module):
    """``variables_from_module(module)["params"]``, each kernel that a model
    axis split by column (its layer's ``parallel`` mode ``"gather"``)
    all-gathered whole."""
    whole = {}
    for name, p in module.named_parameters():
        path, _, attr = name.rpartition(".")
        par = getattr(module.get_submodule(path) if path else module, "parallel", None)
        if attr == "kernel" and par is not None and par.mode == "gather":
            parts = [torch.empty_like(p) for _ in range(par.world)]
            dist.all_gather(parts, p.detach().contiguous(), group=par.group)
            p = torch.cat(parts, dim=1)
        whole[name] = p
    return tree_from_state_dict(whole)


def _merge_shared(new_tree, old_tree):
    """Copy the entries whose names exist in both trees, and whose shapes
    agree, from ``old_tree`` into ``new_tree``."""
    if not isinstance(new_tree, Mapping) or not isinstance(old_tree, Mapping):
        return old_tree if np.shape(new_tree) == np.shape(old_tree) else new_tree
    return {k: _merge_shared(v, old_tree[k]) if k in old_tree else v
            for k, v in new_tree.items()}


class GAN(AbstractGAN):
    """Concrete engine for caller-supplied gen/disc modules."""

    def __init__(self, conf, gen, disc):
        super().__init__(conf, gen=gen, disc=disc)


def compose_gan_with_mode(gen, disc, mode, conf=None, multi_gpu=False, num_gpus=1):
    """``ku``'s module-level wrapper: a :class:`GAN` in ``mode``.
    ``multi_gpu`` / ``num_gpus`` are accepted and unused, as in ``ku``."""
    conf = conf or {"hps": {"composing_mode": mode}}
    conf.setdefault("hps", {})["composing_mode"] = mode
    engine = GAN(conf, gen, disc)
    engine.compose_gan_with_mode(mode)
    return engine


# -- ku's state carried across ----------------------------------------------


def _adam_moments(opt_state):
    """(count, mu, nu) of an Adam state: optax's ``ScaleByAdamState`` (or a
    tuple holding one, as ``optax.adam``'s chain state is), or a dict with
    those keys."""
    if isinstance(opt_state, Mapping):
        return opt_state["count"], opt_state["mu"], opt_state["nu"]
    if hasattr(opt_state, "mu"):
        return opt_state.count, opt_state.mu, opt_state.nu
    return _adam_moments(next(s for s in opt_state if hasattr(s, "mu")))


def state_from_ku(engine: AbstractGAN, state) -> AbstractGAN:
    """Load ``ku``'s GAN state (its dict, leaves as numpy arrays) into
    ``engine``: ``gen_params`` / ``gen_stats`` and ``disc_params`` into the
    modules, each optax ``ScaleByAdamState(count, mu, nu)`` into the side's
    ``torch.optim.Adam`` (``step``, ``exp_avg``, ``exp_avg_sq``), ``step``
    into the generator's train state (the discriminator's takes its Adam
    count). The draws are left as they are."""
    if engine.state is None:
        engine.init_state()
    _load_tree(engine.gen, state["gen_params"], state.get("gen_stats") or {})
    _load_tree(engine.disc, state["disc_params"], state.get("disc_stats") or {})
    for side, module in (("gen", engine.gen), ("disc", engine.disc)):
        count, mu, nu = _adam_moments(state[f"{side}_opt"])
        st = engine.state[side]
        mu = state_dict_from_tree(mu, engine.device)
        nu = state_dict_from_tree(nu, engine.device)
        for name, p in module.named_parameters():
            st.optimizer.state[p] = {
                "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
                "exp_avg": mu[name].to(p.dtype).clone(),
                "exp_avg_sq": nu[name].to(p.dtype).clone(),
            }
        st.step = int(np.asarray(count))
    engine.state["gen"].step = int(np.asarray(state["step"]))
    return engine


def state_to_ku(engine: AbstractGAN) -> Dict:
    """``engine``'s state as ``ku``'s GAN state dict of numpy arrays; each
    optimizer as ``{"count", "mu", "nu"}`` (zeros before its first step)."""
    out = {"step": np.int32(engine.state["gen"].step)}
    for side, module in (("gen", engine.gen), ("disc", engine.disc)):
        v = variables_from_module(module)
        out[f"{side}_params"], out[f"{side}_stats"] = v["params"], v["batch_stats"]
        opt_state = engine.state[side].optimizer.state
        named = list(module.named_parameters())
        count = 0
        mu, nu = {}, {}
        for name, p in named:
            s = opt_state.get(p)
            count = int(s["step"]) if s else 0
            mu[name] = s["exp_avg"] if s else torch.zeros_like(p)
            nu[name] = s["exp_avg_sq"] if s else torch.zeros_like(p)
        out[f"{side}_opt"] = {"count": np.int32(count), "mu": tree_from_state_dict(mu),
                              "nu": tree_from_state_dict(nu)}
    return out
