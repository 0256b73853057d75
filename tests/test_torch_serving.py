"""ku_torch's dense-cache ContinuousBatcher on the CPU.

The bar is ku's (tests/test_serving.py): per request, the batcher emits
exactly the tokens batch-1 ``generate`` emits, through recycled slots,
chunked prefill of long prompts, adaptive chunks, EOS and logprobs (f32
rtol/atol 1e-5); one configuration is also held against ku's own
ContinuousBatcher; and an admission leaves every continuing row's cache bit
for bit as it was. The LM is the tiny one of test_torch_decoding.py:
2 blocks, d 32, 4/2 heads, RoPE, vocabulary 64.
"""

import flax.linen as flnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ku
from ku.nn.serving import ContinuousBatcher as KuBatcher
from ku_torch.nn import ContinuousBatcher, Transformer, generate, make_sampler
from ku_torch.utility import state_dict_from_tree

VOCAB, D, MAX_LEN = 64, 32, 48
BLOCK = dict(causal=True, rope=True, num_kv_head=2, max_decode_len=MAX_LEN)
TOL = dict(rtol=1e-5, atol=1e-5)


class KuLM(flnn.Module):
    @flnn.compact
    def __call__(self, xs, decode=False, prompt_lengths=None):
        x = xs[0]
        for i in range(2):
            x = ku.Transformer(4, D, 0.0, name=f"block{i}", flash_decode=False,
                               **BLOCK)([x], decode=decode,
                                        prompt_lengths=prompt_lengths)
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
def lm():
    rng = np.random.default_rng(21)
    table = rng.normal(size=(VOCAB, D)).astype(np.float32)
    ku_lm = KuLM()
    params = jax.jit(lambda k, x: ku_lm.init(k, [x], decode=True))(
        jax.random.key(4), jnp.zeros((1, 2, D)))["params"]
    port = LM(device="cpu")
    port.load_state_dict(state_dict_from_tree(params, "cpu"), strict=True)
    t = torch.from_numpy(table)
    return dict(ku=ku_lm, params=params, table=jnp.asarray(table), port=port,
                embed=lambda ids, pos=None: t[ids], readout=lambda y: y @ t.T)


def _batcher(lm, **kw):
    return ContinuousBatcher(lm["port"], embed=lm["embed"],
                             readout=lm["readout"], max_decode_len=MAX_LEN,
                             **kw)


def _requests(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=(n,)).astype(np.int64) for n in lengths]


def _alone(lm, prompt, budget, sampler=None):
    kw = {} if sampler is None else {"sampler": sampler}
    ids, lps = generate(lm["port"], torch.from_numpy(prompt)[None], budget,
                        embed=lm["embed"], readout=lm["readout"],
                        return_logprobs=True, **kw)
    return ids[0].numpy(), lps[0].numpy()


def test_batcher_matches_batch1_generate(lm):
    """2 slots, 6 requests: recycled slots, a prompt of 3 prefill rounds
    (11 tokens at prompt_len 4), adaptive chunks (2, 5), logprobs."""
    prompts = _requests(1, (3, 1, 11, 2, 4, 6))
    budgets = [6, 9, 4, 7, 5, 3]
    cb = _batcher(lm, num_slots=2, prompt_len=4, chunk=(2, 5),
                  return_logprobs=True)
    got = cb.serve(prompts, budgets)
    for pr, budget, (toks, lps) in zip(prompts, budgets, got):
        want_ids, want_lp = _alone(lm, pr, budget)
        np.testing.assert_array_equal(toks, want_ids)
        np.testing.assert_allclose(lps, want_lp, **TOL)
    st = cb.last_stats
    assert st["admission_events"] >= 3  # slots were recycled
    assert st["decoded_tokens"] == sum(budgets)
    assert st["prefill_rounds"] > st["admission_events"]  # chunked prefill


def test_batcher_eos_and_repetition_penalty(lm):
    prompts = _requests(2, (2, 3, 5))
    full = _batcher(lm, num_slots=2, prompt_len=4, chunk=2).serve(prompts, 8)
    eos = next(int(t) for out in full for t in out[1:-1])
    cut = _batcher(lm, num_slots=2, prompt_len=4, chunk=2,
                   eos_id=eos).serve(prompts, 8)
    hit = 0
    for f, c in zip(full, cut):
        if eos in f:
            stop = int(np.flatnonzero(f == eos)[0])
            np.testing.assert_array_equal(c, f[:stop + 1])
            hit += 1
        else:
            np.testing.assert_array_equal(c, f)
    assert hit >= 1
    # A sampler that needs the seen mask: deterministic at top_k = 1.
    pen = make_sampler(top_k=1, repetition_penalty=1.5)
    got = _batcher(lm, num_slots=2, prompt_len=4, chunk=3,
                   sampler=pen).serve(prompts, 7)
    for pr, toks in zip(prompts, got):
        np.testing.assert_array_equal(toks, _alone(lm, pr, 7, pen)[0])


def test_batcher_matches_ku_batcher(lm):
    prompts = _requests(3, (3, 1, 4, 2, 4))
    budgets = [6, 9, 4, 7, 5]
    table = lm["table"]
    want = KuBatcher(lm["ku"], lm["params"], embed=lambda i, p=None: table[i],
                     readout=lambda y: y @ table.T, num_slots=2, prompt_len=4,
                     max_decode_len=MAX_LEN, chunk=3).serve(
        [p.astype(np.int32) for p in prompts], budgets)
    got = _batcher(lm, num_slots=2, prompt_len=4, chunk=3).serve(prompts, budgets)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_admission_leaves_continuing_rows_bit_for_bit(lm):
    cb = _batcher(lm, num_slots=3, prompt_len=4, chunk=2)
    cb.reset()
    for pr in _requests(4, (3, 5)):
        cb.submit(pr, 20)
    cb.step()  # admits two requests into slots 0 and 1, decodes a chunk
    before = {k: v.clone() for k, v in cb._cache.items()}
    pending = cb._pending.clone()
    cb.submit(_requests(5, (6,))[0], 4)
    assert cb._admit()  # the new request takes slot 2, in two rounds
    for k, v in cb._cache.items():
        assert torch.equal(v[:2], before[k][:2]), k
        assert not torch.equal(v[2:], before[k][2:]) or k.endswith("index")
    assert torch.equal(cb._pending[:2], pending[:2])


def test_batcher_guards(lm):
    with pytest.raises(ValueError, match="prompt_len"):
        _batcher(lm, num_slots=2, prompt_len=1)
    cb = _batcher(lm, num_slots=2, prompt_len=4)
    with pytest.raises(ValueError, match="non-empty"):
        cb.serve([np.zeros(0, np.int64)], 4)
    with pytest.raises(ValueError, match="overruns"):
        cb.serve([np.zeros(2, np.int64)], 45)
    with pytest.raises(ValueError, match="match"):
        cb.serve([np.zeros(2, np.int64)], [1, 2])
    with pytest.raises(ValueError, match="paged"):
        cb.serve([np.zeros(2, np.int64)], 3, shared_prefix=[1, 2])
    with pytest.raises(TypeError, match="DeviceMesh"):
        _batcher(lm, num_slots=2, prompt_len=4, mesh=object())
    cb = _batcher(lm, num_slots=2, prompt_len=4, chunk=2)
    cb.reset()
    cb.submit(np.zeros(2, np.int64), 20)
    with pytest.raises(RuntimeError, match="discard"):
        cb.reset()
    assert cb.progress() == {}  # queued, not admitted yet
    cb.step()
    assert {rid: len(t) for rid, t in cb.progress().items()} == {0: 2}
    cb.reset(force=True)
    assert cb.idle
