"""Training in ku_torch against ku, on the CPU: gradients through
``use_flash`` attention, the ``Trainer``, and the position encodings.

The same numpy-made inputs and ku's params (carried across by
``state_dict_from_tree``) go through both packages. On the CPU ku
differentiates its flash attention through XLA (its custom VJP takes the
Pallas backward only on a TPU), the port through its autograd function over
the plain forward and backward (tests/test_torch_flash_backward.py holds
that backward against ku's Pallas one). Tolerances: gradients f32 rtol 1e-4
/ atol 1e-5 (sums in other orders, through a few products); the Trainer's
per-epoch losses rtol 1e-4 and its final params atol 1e-5 at lr 1e-3 (Adam
moves every parameter by about lr a step whatever its gradient's size, so
rounding differences in the gradients stay far below lr); position
encodings exactly.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import ku
from ku.engine_ext import Trainer as KuTrainer
from ku_torch.engine_ext import Trainer, adam
from ku_torch.kernels import flash_attention as fa
from ku_torch.nn import (
    Dense,
    MultiHeadAttention,
    OrdinalPositionEncoding,
    PeriodicPositionEncoding,
    Transformer,
)
from ku_torch.utility import state_dict_from_tree

_XDIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "examples", "transformer")
sys.path.insert(0, _XDIR)
try:
    from transformer_classify import TransformerClassifier, make_dataset, softmax_xent
finally:
    sys.path.remove(_XDIR)

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_flat(value, path))
        else:
            out[path] = np.asarray(value)
    return out


@pytest.fixture
def flash_backward_calls(monkeypatch):
    """Counts calls of the flash backward's plain version (the CPU's
    backward of use_flash attention)."""
    calls = []
    plain = fa.flash_bwd_torch

    def spy(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(fa, "flash_bwd_torch", spy)
    return calls


GRAD_CASES = {
    "mha_gqa_rope_softcap": (
        lambda d: ku.nn.MultiHeadAttention(4, d, 0.0, use_flash=True, causal=True,
                                           num_kv_head=2, rope=True, logit_softcap=2.0),
        lambda d: MultiHeadAttention(4, d, 0.0, use_flash=True, causal=True,
                                     num_kv_head=2, rope=True, logit_softcap=2.0,
                                     device="cpu"),
        True, 1),
    "mha_window_segments": (
        lambda d: ku.nn.MultiHeadAttention(4, d, 0.0, use_flash=True, causal=True,
                                           window=3, num_kv_head=1),
        lambda d: MultiHeadAttention(4, d, 0.0, use_flash=True, causal=True, window=3,
                                     num_kv_head=1, device="cpu"),
        True, 1),
    "transformer_causal_rope_gqa": (
        lambda d: ku.Transformer(4, d, 0.0, use_flash=True, causal=True, rope=True,
                                 num_kv_head=2),
        lambda d: Transformer(4, d, 0.0, use_flash=True, causal=True, rope=True,
                              num_kv_head=2, device="cpu"),
        False, 2),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_gradients_through_use_flash_match_jax_grad(rng, case, flash_backward_calls):
    make_ku, make_port, mha, n_flash = GRAD_CASES[case]
    b, n, d = 2, 9, 16
    x = rng.normal(size=(b, n, d)).astype(np.float32)
    cot = rng.normal(size=(b, n, d)).astype(np.float32)
    seg = np.array([[0, 0, 0, 0, 1, 1, 1, 1, 1], [0, 0, 1, 1, 1, 1, 2, 2, 2]], np.int32)
    call = dict(segment_ids=seg) if "segments" in case else {}
    layer = make_ku(d)

    def inputs(t):
        return [t, t, t] if mha else [t]

    params = jax.jit(lambda key, x: layer.init(key, inputs(x), **call))(
        jax.random.key(0), jnp.asarray(x))["params"]

    def loss(p, x):
        return jnp.sum(layer.apply({"params": p}, inputs(x), **call) * cot)

    want_p, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))

    port = make_port(d)
    port.load_state_dict(state_dict_from_tree(params, "cpu"), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    tcall = {k: torch.from_numpy(v) for k, v in call.items()}
    (port(inputs(xt), deterministic=False, **tcall) * torch.from_numpy(cot)).sum().backward()
    assert len(flash_backward_calls) == n_flash  # every sublayer's backward
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), **GRAD_TOL)
    want = _flat(want_p)
    got = {name: p.grad for name, p in port.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name], **GRAD_TOL, err_msg=name)


class Classifier(torch.nn.Module):
    """The port of transformer_classify's TransformerClassifier (example
    code, so it lives here): Embed → PeriodicPositionEncoding → blocks →
    Dense(2) on position 0, ku's names (``embed`` is a torch Embedding whose
    ``weight`` is flax's ``embed/embedding``)."""

    def __init__(self, vocab, seq_len, d_model, num_head, num_blocks, use_flash):
        super().__init__()
        self.embed = torch.nn.Embedding(vocab, d_model)
        self.pe = PeriodicPositionEncoding(seq_len, d_model, device="cpu")
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block_{i}", Transformer(num_head, d_model, 0.0,
                                                      use_flash=use_flash,
                                                      device="cpu"))
        self.head = Dense(d_model, 2, device="cpu")

    def forward(self, tokens, deterministic=True):
        x = self.pe(self.embed(tokens.long()))
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")([x], deterministic=deterministic)
        return self.head(x[:, 0])

    def load_ku(self, params):
        sd = state_dict_from_tree(params, "cpu")
        sd["embed.weight"] = sd.pop("embed.embedding")
        self.load_state_dict(sd, strict=True)

    def ku_params(self):
        return {("embed.embedding" if k == "embed.weight" else k): v.detach().numpy()
                for k, v in self.state_dict().items()}


def xent(y_true, logits):
    return F.cross_entropy(logits, y_true.long(), reduction="none")


def test_trainer_fit_matches_ku(flash_backward_calls):
    """Trainer.fit on TransformerClassifier(use_flash=True), 2 epochs of 3
    batches (a ragged tail of 4 rows dropped): per-epoch losses and final
    params against ku's Trainer.fit; then test_step and predict."""
    x, y = make_dataset(100, 12, 16, seed=0)
    arch = dict(vocab=16, seq_len=12, d_model=32, num_head=4, num_blocks=1)
    ku_model = TransformerClassifier(**arch, use_flash=True)
    ku_tr = KuTrainer(ku_model, softmax_xent, optimizer=optax.adam(1e-3),
                      rng_streams=("dropout",))
    ku_tr.init(jnp.asarray(x[:1]))
    port = Classifier(**arch, use_flash=True)
    port.load_ku(ku_tr.state["params"])
    tr = Trainer(port, xent, optimizer=adam(1e-3), rng_streams=("dropout",))

    want = ku_tr.fit(x, y, batch_size=32, epochs=2, verbose=0)
    got = tr.fit(x, y, batch_size=32, epochs=2, verbose=0)
    assert tr.step == 6 and len(flash_backward_calls) == 6 * 2
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[1] < got[0]
    want_p = _flat(ku_tr.state["params"])
    got_p = port.ku_params()
    assert set(got_p) == set(want_p)
    for name, value in got_p.items():
        np.testing.assert_allclose(value, want_p[name], rtol=0, atol=1e-5, err_msg=name)

    xt, yt = make_dataset(40, 12, 16, seed=1)
    np.testing.assert_allclose(tr.test_step(xt, yt)["loss"],
                               ku_tr.test_step(jnp.asarray(xt), jnp.asarray(yt))["loss"],
                               rtol=1e-4)
    logits = tr.predict(xt, batch_size=16)
    assert logits.shape == (40, 2) and logits.dtype == np.float32
    np.testing.assert_allclose(logits, ku_tr.predict(xt, batch_size=16),
                               rtol=1e-4, atol=1e-5)
    assert len(flash_backward_calls) == 12  # testing and predicting: no backward


class Rows:
    name = "rows"

    def __call__(self, y_true, y_pred):
        return int(y_true.shape[0])


def test_trainer_train_step_and_draws():
    """train_step returns the batch's loss and metrics and steps the
    optimizer; with rng_streams the dropout draws follow the seed alone."""
    x, y = make_dataset(16, 12, 16, seed=2)

    def run(seed):
        torch.manual_seed(seed + 100)  # the global RNG must not matter
        model = Classifier(16, 12, 32, 4, 1, use_flash=True)
        model.load_state_dict(base)
        for m in model.modules():
            if isinstance(m, (Transformer, MultiHeadAttention)):
                m.dropout_rate = 0.3
        tr = Trainer(model, xent, metrics=[Rows()], seed=seed,
                     rng_streams=("dropout",))
        return [tr.train_step(x, y) for _ in range(3)], tr

    base = Classifier(16, 12, 32, 4, 1, use_flash=True).state_dict()
    a, tr = run(0)
    b, _ = run(0)
    c, _ = run(1)
    assert tr.step == 3 and a[0]["rows"] == 16
    assert [s["loss"] for s in a] == [s["loss"] for s in b]
    assert [s["loss"] for s in a] != [s["loss"] for s in c]
    assert all(p.grad is not None for p in tr.module.parameters())
    # has_batch_stats=True is accepted: the statistics live in the module's
    # buffers (tests/test_torch_spec_autoencoder.py holds a batch-statistics
    # fit against ku's).
    assert Trainer(tr.module, xent, has_batch_stats=True).has_batch_stats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_position_encodings_match_ku(rng, dtype):
    x = rng.normal(size=(2, 7, 12)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    for ku_pe, port_pe in (
            (ku.nn.OrdinalPositionEncoding(num_total_seq=10), OrdinalPositionEncoding(10)),
            (ku.nn.PeriodicPositionEncoding(max_seq=10, d_f=12),
             PeriodicPositionEncoding(10, 12, device="cpu"))):
        xj = jnp.asarray(x, jdt)
        want = np.asarray(ku_pe.apply({}, xj).astype(jnp.float32))
        got = port_pe(torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt and not dict(port_pe.state_dict())
        np.testing.assert_array_equal(got.float().numpy(), want)
