"""RL-based hyperparameter search harness (actor-critic), in torch.

Port of ``examples/style_based_gan/style_based_gan_trainer.py``:

- the **actor** maps a constant context to a Gaussian action in [-1, 1]^n
  (a tanh mean and a learned log-std); each action dimension is scaled into
  a hyperparameter's range (log-uniform for learning rates);
- the **critic** estimates the score of an action; both update from the
  observed reward with a TD(0) target ``r + γ·V(s')``, each by its own Adam
  (``ku_torch.engine_ext.adam``, optax's formula);
- ``optimize(train_fn, n_trials)`` runs propose → train → update.

The modules keep flax's names (``Dense_0``, ``Dense_1``, ``log_std``), so
``ku``'s parameters load into them; the action noise is drawn from the
tuner's ``torch.Generator`` (it cannot match JAX's draws).

The demo (``main``) tunes the RBM example's CD learning rate on binarized
MNIST rows, maximizing the negative reconstruction error; each trial is one
``RBM.fit``, on a GPU one launch of the CD kernel
(``ku_torch.kernels.cd_gibbs``). Run from the repository root: ``python
examples_torch/style_based_gan/style_based_gan_trainer.py [--device cpu]
[--trials N]`` (the card by default).
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from typing import Callable, Dict, Sequence, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch import nn  # noqa: E402

from examples_torch import common  # noqa: E402
from ku_torch.engine_ext import adam  # noqa: E402
from ku_torch.nn import Dense  # noqa: E402


class _Actor(nn.Module):
    def __init__(self, n_actions: int, *, device, generator):
        super().__init__()
        self.Dense_0 = Dense(1, 32, device=device, generator=generator)
        self.Dense_1 = Dense(32, n_actions, device=device, generator=generator)
        self.log_std = nn.Parameter(torch.full((n_actions,), -0.5, device=device))

    def forward(self, ctx):
        return torch.tanh(self.Dense_1(torch.relu(self.Dense_0(ctx)))), self.log_std


class _Critic(nn.Module):
    def __init__(self, n_actions: int, *, device, generator):
        super().__init__()
        self.Dense_0 = Dense(1 + n_actions, 32, device=device, generator=generator)
        self.Dense_1 = Dense(32, 1, device=device, generator=generator)

    def forward(self, ctx, action):
        return self.Dense_1(torch.relu(self.Dense_0(torch.cat([ctx, action], -1))))[..., 0]


class HPRange:
    """One hyperparameter's action → value scaling."""

    def __init__(self, name: str, low: float, high: float, log: bool = False,
                 integer: bool = False):
        self.name, self.low, self.high, self.log, self.integer = name, low, high, log, integer

    def from_action(self, a: float) -> float:
        t = (float(a) + 1.0) / 2.0  # [-1, 1] → [0, 1]
        if self.log:
            v = math.exp(math.log(self.low) + t * (math.log(self.high) - math.log(self.low)))
        else:
            v = self.low + t * (self.high - self.low)
        return int(round(v)) if self.integer else v


class StyleGANTrainer:
    """Actor-critic hyperparameter optimizer."""

    def __init__(self, hp_ranges: Sequence[HPRange], gamma: float = 0.9, lr: float = 1e-2,
                 seed: int = 0, device="cuda"):
        self.hp_ranges = list(hp_ranges)
        self.gamma = gamma
        self.device = torch.device(device)
        n = len(self.hp_ranges)
        init = torch.Generator().manual_seed(seed)
        self.actor = _Actor(n, device="cpu", generator=init).to(self.device)
        self.critic = _Critic(n, device="cpu", generator=init).to(self.device)
        self.actor_opt = adam(lr)(list(self.actor.parameters()))
        self.critic_opt = adam(lr)(list(self.critic.parameters()))
        self.draws = torch.Generator(device=self.device).manual_seed(seed)
        self.history = []

    def _ctx(self):
        return torch.ones((1, 1), device=self.device)

    def propose(self) -> Tuple[Dict[str, float], torch.Tensor]:
        with torch.no_grad():
            mean, log_std = self.actor(self._ctx())
            eps = torch.randn(mean.shape, generator=self.draws, device=self.device)
            action = (mean + torch.exp(log_std) * eps).clamp(-1.0, 1.0)
        hps = {r.name: r.from_action(action[0, i]) for i, r in enumerate(self.hp_ranges)}
        return hps, action

    def update(self, action, reward: float, next_value: float = 0.0):
        """TD(0): the critic toward ``target = r + γ·V(s')``, then the actor
        along ``log π(action)`` times the advantage ``target − V(action)``
        read after the critic's step. Returns (critic loss, actor loss)."""
        ctx = self._ctx()
        action = torch.as_tensor(action, device=self.device, dtype=torch.float32)
        target = reward + self.gamma * next_value
        self.critic_opt.zero_grad()
        c_loss = ((self.critic(ctx, action) - target) ** 2).mean()
        c_loss.backward()
        self.critic_opt.step()
        with torch.no_grad():
            advantage = target - float(self.critic(ctx, action)[0])
        self.actor_opt.zero_grad()
        mean, log_std = self.actor(ctx)
        logp = -0.5 * (((action - mean) / torch.exp(log_std)) ** 2 + 2 * log_std
                       + math.log(2 * math.pi)).sum(dim=-1)
        a_loss = -logp.mean() * advantage
        a_loss.backward()
        self.actor_opt.step()
        return float(c_loss.detach()), float(a_loss.detach())

    def optimize(self, train_fn: Callable[[Dict[str, float]], float], n_trials: int = 10,
                 verbose: int = 1):
        """Propose → train → update; returns the best (hps, score)."""
        best = (None, -np.inf)
        for t in range(n_trials):
            hps, action = self.propose()
            score = float(train_fn(hps))
            self.update(action, score)
            self.history.append((hps, score))
            if score > best[1]:
                best = (hps, score)
            if verbose:
                print(f"trial {t + 1}/{n_trials}: score {score:.4f} hps {hps}")
        return best


def main(device: str = "cuda", n_trials: int = 5, V=None):
    """Demo: tune the RBM's CD learning rate on the first 1,024 binarized
    rows, each trial one ``RBM.fit`` epoch; returns the best (hps, score)."""
    from ku_torch.ebm import RBM

    if V is None:
        V, _ = common.load_mnist()
    Vb = (np.asarray(V) / 255.0 > 0.5).astype(np.float32)[:1024]

    def train_fn(hps):
        rbm = RBM({"lr": hps["lr"], "batch_size": 128, "epochs": 1}, 128, seed=0,
                  device=device)
        rbm.fit(Vb, verbose=0)
        g = torch.Generator(device=rbm.device)
        h = rbm.transform(Vb[:256], generator=g.manual_seed(0))
        v_rec = rbm.inv_transform(h, generator=g.manual_seed(1))
        return -float((v_rec - torch.from_numpy(Vb[:256]).to(rbm.device)).abs().mean())

    tuner = StyleGANTrainer([HPRange("lr", 1e-4, 1e-1, log=True)], device=device)
    best_hps, best_score = tuner.optimize(train_fn, n_trials=n_trials)
    print(f"best: {best_hps} (score {best_score:.4f})")
    return best_hps, best_score


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trials", type=int, default=5)
    args = ap.parse_args()
    main(args.device, args.trials)
