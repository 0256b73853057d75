"""GAN and classification losses, and the gradient penalties (port of
``ku/loss_ext/loss.py``).

- ``wgan_loss``: mean(y_pred) over the last axis (the ±1 sign comes from
  the loss weights).
- ``softplus_loss`` / ``softplus_inverse_loss``: softplus(±y_pred), the
  non-saturating StyleGAN pair.
- ``lsgan_loss``: mean((y_pred − y_true)²) over the last axis.
- ``categorical_crossentropy_with_label_gt``: integer labels one-hot
  (an out-of-range label gives a zero row, as ``jax.nn.one_hot`` does),
  optional label smoothing, probabilities clipped to [ε, 1 − ε].
- ``wgan_gp_loss``: λ/target²·(‖∇‖ − target)², with ‖∇‖ = sqrt(Σ∇² + ε).
- ``r_penalty_loss``: γ/2·Σ∇² over the non-batch axes.
- ``r1_penalty`` / ``gradient_penalty`` take ∇ₓ ΣD(x) through
  ``torch.autograd.grad(..., create_graph=True)``, so a GAN step can take a
  gradient of the penalty (``ku`` takes it with ``jax.grad``).
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

EPSILON = 1e-7


def wgan_loss(y_true, y_pred):
    return y_pred.mean(dim=-1)


def softplus_loss(y_true, y_pred):
    return F.softplus(y_pred)


def softplus_inverse_loss(y_true, y_pred):
    return F.softplus(-1.0 * y_pred)


def lsgan_loss(y_true, y_pred):
    return (y_pred - y_true).square().mean(dim=-1)


def categorical_crossentropy_with_label_gt(
    y_true, y_pred, num_classes: int = 2, from_logits: bool = False,
    label_smoothing: float = 0.0,
):
    """CCE against integer labels."""
    ids = torch.as_tensor(y_true, device=y_pred.device).long()
    classes = torch.arange(num_classes, device=y_pred.device)
    y_true = (ids[..., None] == classes).to(y_pred.dtype)
    if label_smoothing:
        y_true = y_true * (1.0 - label_smoothing) + label_smoothing / num_classes
    if from_logits:
        log_p = torch.log_softmax(y_pred, dim=-1)
    else:
        log_p = torch.log(torch.clamp(y_pred, EPSILON, 1.0 - EPSILON))
    return -(y_true * log_p).sum(dim=-1)


def _grad_sq_norm(grads):
    """Σ over the non-batch axes of grad²."""
    return grads.square().sum(dim=tuple(range(1, grads.dim())))


def wgan_gp_loss(grads, wgan_lambda: float = 10.0, wgan_target: float = 1.0):
    """λ/target²·(‖∇‖ − target)² from explicit input gradients."""
    norm = torch.sqrt(_grad_sq_norm(grads) + EPSILON)
    return (wgan_lambda / (wgan_target ** 2)) * (norm - wgan_target).square()


def r_penalty_loss(grads, r_gamma: float = 10.0):
    """R1 penalty γ/2·‖∇‖² from explicit input gradients."""
    return r_gamma * 0.5 * _grad_sq_norm(grads)


def input_grad(disc_fn, x):
    """∇ₓ ΣD(x), kept in the graph. A tensor that needs no gradient is
    differentiated through a detached copy, so the caller's is not
    changed."""
    if not x.requires_grad:
        x = x.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(disc_fn(x).sum(), x, create_graph=True)
    return grads


def r1_penalty(disc_fn, x, r_gamma: float = 10.0):
    """The R1 penalty end to end; differentiable again."""
    return r_penalty_loss(input_grad(disc_fn, x), r_gamma)


def gradient_penalty(disc_fn, x_interp, wgan_lambda: float = 10.0,
                     wgan_target: float = 1.0):
    """WGAN-GP on interpolated inputs; differentiable again."""
    return wgan_gp_loss(input_grad(disc_fn, x_interp), wgan_lambda, wgan_target)


# -- class wrappers ----------------------------------------------------------


class _LossWrapper:
    reduction_mean = True

    def __call__(self, y_true, y_pred):
        out = self.fn(y_true, y_pred)
        return out.mean() if self.reduction_mean else out


class WGANLoss(_LossWrapper):
    fn = staticmethod(wgan_loss)


class SoftPlusLoss(_LossWrapper):
    fn = staticmethod(softplus_loss)


class SoftPlusInverseLoss(_LossWrapper):
    fn = staticmethod(softplus_inverse_loss)


class CategoricalCrossentropyWithLabelGT(_LossWrapper):
    def __init__(self, num_classes: int = 2, from_logits: bool = False,
                 label_smoothing: float = 0.0):
        self.num_classes = num_classes
        self.from_logits = from_logits
        self.label_smoothing = label_smoothing

    def __call__(self, y_true, y_pred):
        return categorical_crossentropy_with_label_gt(
            y_true, y_pred, self.num_classes, self.from_logits,
            self.label_smoothing).mean()


class WGANGPLoss:
    """The WGAN-GP penalty from explicit input gradients, batch mean."""

    def __init__(self, wgan_lambda: float = 10.0, wgan_target: float = 1.0):
        self.wgan_lambda = wgan_lambda
        self.wgan_target = wgan_target

    def __call__(self, grads):
        return wgan_gp_loss(grads, self.wgan_lambda, self.wgan_target).mean()


class RPenaltyLoss:
    """The R1 penalty from explicit input gradients, batch mean."""

    def __init__(self, r_gamma: float = 10.0):
        self.r_gamma = r_gamma

    def __call__(self, grads):
        return r_penalty_loss(grads, self.r_gamma).mean()
