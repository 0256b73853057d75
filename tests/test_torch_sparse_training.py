"""Block-sparse attention in ku_torch's layers against ku's, on the CPU:
``MultiHeadAttention(block_mask=...)`` and ``Transformer`` blocks, their
outputs and gradients against ``jax.grad`` of ku's, ku's rejections with
ku's messages, and a ``Trainer`` fit under a mask.

The same numpy-made inputs and ku's params (carried across by
``state_dict_from_tree``) go through both packages. ku's custom VJP runs its
Pallas forward and backward in interpret mode here; the port's autograd
function runs the plain versions (tests/test_torch_sparse_attention.py holds
those against ku's kernels). Tolerance: rtol 1e-4 / atol 1e-5, ku's own for
``test_mha_block_mask`` (tests/test_sparse_attention.py), since the two sum
in other orders through a few products.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import ku
from ku.pallas.sparse_attention import make_block_mask as ku_make_block_mask
from ku_torch.engine_ext import Trainer, adam
from ku_torch.kernels import flash_attention as fa
from ku_torch.kernels import sparse_attention as sa
from ku_torch.nn import MultiHeadAttention, Transformer
from ku_torch.utility import state_dict_from_tree

TOL = dict(rtol=1e-4, atol=1e-5)
N, D, H, HKV = 48, 32, 4, 2
MASK_KW = dict(block_q=16, block_k=16, causal=True, window=20, global_prefix=3)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_flat(value, path))
        else:
            out[path] = np.asarray(value)
    return out


class KuStack(fnn.Module):
    """Two of ku's Transformer blocks (auto-named Transformer_0/1)."""

    @fnn.compact
    def __call__(self, x, block_mask):
        for _ in range(2):
            x = ku.Transformer(H, D, 0.0, causal=True, rope=True, num_kv_head=HKV)(
                [x], block_mask=block_mask)
        return x


class Stack(torch.nn.Module):
    """The port of KuStack, under the same names."""

    def __init__(self, mask):
        super().__init__()
        self.mask = mask
        for j in range(2):
            self.add_module(f"Transformer_{j}", Transformer(
                H, D, 0.0, causal=True, rope=True, num_kv_head=HKV, device="cpu"))

    def forward(self, x, deterministic=True):
        for j in range(2):
            x = getattr(self, f"Transformer_{j}")([x], deterministic=deterministic,
                                                  block_mask=self.mask)
        return x


@pytest.fixture
def sparse_backward_calls(monkeypatch):
    """Counts calls of the plain sparse and flash backwards (the CPU's
    backward of block-sparse attention must be the sparse one)."""
    calls = {"sparse": 0, "flash": 0}
    for name, attr in (("sparse", "sparse_bwd_torch"), ("flash", "flash_bwd_torch")):
        module = sa if name == "sparse" else fa
        plain = getattr(module, attr)

        def spy(*a, _plain=plain, _name=name, **kw):
            calls[_name] += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(module, attr, spy)
    return calls


def test_transformer_blocks_with_a_block_mask_match_jax_grad(rng, sparse_backward_calls):
    """Two blocks (d 32, 4 heads over 2, RoPE) under a window + sinks mask:
    output, input gradient and every parameter's gradient."""
    x = rng.normal(size=(1, N, D)).astype(np.float32)
    cot = rng.normal(size=(1, N, D)).astype(np.float32)
    ku_mask = ku_make_block_mask(N, **MASK_KW)
    stack = KuStack()
    params = jax.jit(lambda key, x: stack.init(key, x, ku_mask))(
        jax.random.key(0), jnp.asarray(x))["params"]

    def loss(p, x):
        y = stack.apply({"params": p}, x, ku_mask)
        return jnp.sum(y * cot), y

    (_, want_y), (want_p, want_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    port = Stack(sa.make_block_mask(N, **MASK_KW))
    port.load_state_dict(state_dict_from_tree(params, "cpu"), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    y = port(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **TOL)
    (y * torch.from_numpy(cot)).sum().backward()
    assert sparse_backward_calls == {"sparse": 4, "flash": 0}  # every sublayer's
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), **TOL)
    want = _flat(want_p)
    got = {name: p.grad for name, p in port.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name], **TOL, err_msg=name)


@pytest.mark.parametrize("use_flash", [False, True])
def test_mha_block_mask_output_matches_ku(rng, use_flash):
    """The layer alone, forward only, with and without use_flash: the mask
    takes precedence over the flash path, as in ku."""
    x = rng.normal(size=(2, 64, 8)).astype(np.float32)
    kw = dict(block_q=16, block_k=16, causal=True, window=20, global_prefix=3)
    layer = ku.MultiHeadAttention(2, 8, 0.0, causal=True, use_flash=use_flash)
    ku_mask = ku_make_block_mask(64, **kw)
    xs = [jnp.asarray(x)] * 3
    params = jax.jit(lambda key, xs: layer.init(key, xs))(jax.random.key(1), xs)
    want = jax.jit(lambda v, xs: layer.apply(v, xs, block_mask=ku_mask))(params, xs)
    port = MultiHeadAttention(2, 8, 0.0, causal=True, use_flash=use_flash, device="cpu")
    port.load_state_dict(state_dict_from_tree(params["params"], "cpu"), strict=True)
    with torch.no_grad():
        got = port([torch.from_numpy(x)] * 3, block_mask=sa.make_block_mask(64, **kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (layer fields, call arguments): each rejected by ku and the port alike.
REJECTED = {
    "causal_conflict": (dict(causal=False), {}),
    "window_conflict": (dict(causal=True, window=20), {}),
    "sinks_conflict": (dict(causal=True, window=20, global_prefix=3), {}),
    "dropout": (dict(causal=True, dropout_rate=0.5), dict(deterministic=False)),
    "segment_ids": (dict(causal=True), dict(segment_ids=np.zeros((2, 64), np.int32))),
    "use_mask": (dict(causal=True, use_mask=True), {}),
    "plain_similarity": (dict(causal=True, similarity_type="plain"), {}),
    "softcap": (dict(causal=True, logit_softcap=2.0), {}),
    "decode": (dict(causal=True, max_decode_len=64), dict(decode=True)),
}


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_block_mask_rejects_what_ku_rejects(name):
    fields, call = dict(REJECTED[name][0]), REJECTED[name][1]
    x = np.zeros((2, 64, 8), np.float32)
    kw = dict(block_q=16, block_k=16, causal=True, window=20, global_prefix=3)
    dropout = fields.pop("dropout_rate", 0.0)
    layer = ku.MultiHeadAttention(2, 8, dropout, **fields)
    variables = ku.MultiHeadAttention(2, 8, 0.0, causal=True).init(
        jax.random.key(0), [jnp.asarray(x)] * 3)
    ku_call = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in call.items()}
    with pytest.raises(ValueError) as want:
        layer.apply(variables, [jnp.asarray(x)] * 3, block_mask=ku_make_block_mask(64, **kw),
                    rngs={"dropout": jax.random.key(1)}, **ku_call)
    port = MultiHeadAttention(2, 8, dropout, device="cpu", **fields)
    port_call = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                 for k, v in call.items()}
    with pytest.raises(ValueError) as got:
        port([torch.from_numpy(x)] * 3, block_mask=sa.make_block_mask(64, **kw),
             **port_call)
    assert str(got.value) == str(want.value)


class TinyLM(torch.nn.Module):
    """Two blocks under a block mask between a tied embedding and readout."""

    def __init__(self, mask):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.embed = torch.nn.Embedding(20, D)
        with torch.no_grad():
            self.embed.weight.copy_(torch.randn(20, D, generator=gen))
        self.core = Stack(mask)

    def forward(self, ids, deterministic=True):
        return self.core(self.embed(ids), deterministic) @ self.embed.weight.T


def _xent(y_true, logits):
    return F.cross_entropy(logits.transpose(1, 2), y_true, reduction="none").mean(-1)


def test_trainer_fits_under_a_block_mask(sparse_backward_calls):
    """Trainer.fit on a tiny LM whose blocks hold the mask: each step's
    backward goes through the sparse backward (4 sublayers), the loss on a
    repeated motif falls, and predict takes the forward alone."""
    rng = np.random.default_rng(5)
    motif = rng.integers(0, 20, size=(8, 8))
    seqs = torch.from_numpy(np.tile(motif, (1, 7))[:, :N + 1])
    lm = TinyLM(sa.make_block_mask(N, **MASK_KW))
    tr = Trainer(lm, _xent, optimizer=adam(3e-3))
    history = tr.fit(seqs[:, :-1], seqs[:, 1:], batch_size=4, epochs=3, verbose=0)
    assert tr.step == 6 and sparse_backward_calls == {"sparse": 6 * 4, "flash": 0}
    assert all(np.isfinite(history)) and history[-1] < history[0]
    logits = tr.predict(seqs[:, :-1], batch_size=4)
    assert logits.shape == (8, N, 20) and np.isfinite(logits).all()
    assert sparse_backward_calls["sparse"] == 6 * 4
