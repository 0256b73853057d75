"""ku_torch's generate and samplers against ku's, on the CPU, through a tiny
LM: 2 Transformer blocks, d 32, 4 query heads over 2 KV heads, RoPE,
vocabulary 64, a tied embedding table.

Greedy (and top-k = 1) ids must be equal exactly; log-probabilities agree
at f32 rtol/atol 1e-5 (the frameworks sum in other orders).
"""

import flax.linen as flnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ku
from ku.nn import decoding as ku_decoding
from ku_torch.nn import (
    Transformer,
    generate,
    greedy,
    make_sampler,
    mask_after_eos,
)
from ku_torch.utility import state_dict_from_tree

VOCAB, D, MAX_LEN = 64, 32, 40
BLOCK = dict(causal=True, rope=True, num_kv_head=2, max_decode_len=MAX_LEN,
             flash_decode=False)
TOL = dict(rtol=1e-5, atol=1e-5)


class KuLM(flnn.Module):
    @flnn.compact
    def __call__(self, xs, decode=False, prompt_lengths=None):
        x = xs[0]
        for i in range(2):
            x = ku.Transformer(4, D, 0.0, name=f"block{i}", **BLOCK)(
                [x], decode=decode, prompt_lengths=prompt_lengths)
        return x


class LM(torch.nn.Module):
    def __init__(self, **kw):
        super().__init__()
        for i in range(2):
            self.add_module(f"block{i}", Transformer(4, D, **BLOCK, **kw))

    def forward(self, xs, decode=False, prompt_lengths=None, cache=None):
        x = xs[0]
        for i in range(2):
            out = getattr(self, f"block{i}")([x], decode=decode,
                                             prompt_lengths=prompt_lengths,
                                             cache=cache, scope=f"block{i}")
            x, cache = out if decode else (out, cache)
        return (x, cache) if decode else x


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(11)
    table = rng.normal(size=(VOCAB, D)).astype(np.float32)
    ku_lm = KuLM()
    params = jax.jit(lambda k, x: ku_lm.init(k, [x], decode=True))(
        jax.random.key(3), jnp.zeros((1, 2, D)))["params"]
    port = LM(device="cpu")
    port.load_state_dict(state_dict_from_tree(params, "cpu"), strict=True)
    t = torch.from_numpy(table)
    return dict(ku=ku_lm, params=params, table=jnp.asarray(table), port=port,
                embed=lambda ids, pos=None: t[ids], readout=lambda y: y @ t.T)


@pytest.mark.parametrize("ragged", [False, True])
def test_generate_greedy_matches_ku(pair, ragged):
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, VOCAB, size=(3, 7)).astype(np.int64)
    lens = np.array([7, 3, 5], np.int32) if ragged else None
    table = pair["table"]
    want_ids, want_lp = [np.asarray(a) for a in jax.jit(
        lambda params, ids, lens: ku_decoding.generate(
            pair["ku"], params, ids, 9, embed=lambda i, p=None: table[i],
            readout=lambda y: y @ table.T, return_logprobs=True,
            prompt_lengths=lens))(pair["params"], jnp.asarray(prompts), lens)]
    got_ids, got_lp = generate(
        pair["port"], torch.from_numpy(prompts), 9, embed=pair["embed"],
        readout=pair["readout"], return_logprobs=True,
        prompt_lengths=None if lens is None else torch.from_numpy(lens))
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, **TOL)


def test_top_k_one_and_repetition_penalty_match_ku(pair):
    """make_sampler(top_k=1) is greedy in both packages, and with a
    repetition penalty the port emits ku's ids."""
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, 8, size=(2, 6)).astype(np.int64)  # repeats
    table = pair["table"]
    pen = make_sampler(top_k=1, repetition_penalty=1.3)
    ku_pen = ku_decoding.make_sampler(top_k=1, repetition_penalty=1.3)
    ku_top1 = ku_decoding.make_sampler(top_k=1)

    @jax.jit
    def run(params, ids):
        kw = dict(embed=lambda i, p=None: table[i],
                  readout=lambda y: y @ table.T)
        return (ku_decoding.generate(pair["ku"], params, ids, 12, **kw),
                ku_decoding.generate(pair["ku"], params, ids, 12,
                                     sampler=ku_top1, **kw),
                ku_decoding.generate(pair["ku"], params, ids, 12,
                                     sampler=ku_pen, **kw))

    ku_greedy, ku_k1, ku_rep = (np.asarray(a) for a in run(
        pair["params"], jnp.asarray(prompts)))
    kw = dict(embed=pair["embed"], readout=pair["readout"])
    ids = torch.from_numpy(prompts)
    port_greedy = generate(pair["port"], ids, 12, **kw).numpy()
    port_k1 = generate(pair["port"], ids, 12, sampler=make_sampler(top_k=1),
                       **kw).numpy()
    port_rep = generate(pair["port"], ids, 12, sampler=pen, **kw).numpy()
    np.testing.assert_array_equal(ku_k1, ku_greedy)
    np.testing.assert_array_equal(port_k1, port_greedy)
    np.testing.assert_array_equal(port_greedy, ku_greedy)
    np.testing.assert_array_equal(port_rep, ku_rep)
    assert (port_rep != port_greedy).any()  # the penalty changed something


def test_samplers_draw_from_the_generator():
    logits = torch.randn(4, 10, generator=torch.Generator().manual_seed(0))
    s = make_sampler(temperature=0.7, top_k=5, top_p=0.9)
    a = s(logits, torch.Generator().manual_seed(1))
    b = s(logits, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b)
    top5 = torch.topk(logits, 5).indices
    assert all(int(t) in top5[i].tolist() for i, t in enumerate(a))
    np.testing.assert_array_equal(greedy(logits).numpy(),
                                  logits.argmax(-1).numpy())
    with pytest.raises(ValueError, match="seen"):
        make_sampler(repetition_penalty=1.2)(logits)
    for kw in (dict(top_p=0.0), dict(top_k=0), dict(repetition_penalty=0.0)):
        with pytest.raises(ValueError):
            make_sampler(**kw)


def test_mask_after_eos_matches_ku():
    ids = np.array([[1, 2, 3, 4, 5], [3, 3, 1, 3, 2], [0, 1, 2, 4, 4]])
    want_ids, want_len = ku_decoding.mask_after_eos(jnp.asarray(ids), 3, pad_id=9)
    got_ids, got_len = mask_after_eos(torch.from_numpy(ids), 3, pad_id=9)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
