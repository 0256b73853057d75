"""ku_torch's ContinuousBatcher over a page pool, on the CPU.

Held against ku's paged ContinuousBatcher (greedy ids exactly, and the
scheduler's counters: admission_events, prefill_rounds, chunks,
wasted_slot_steps, decoded_tokens, peak_pages_in_use, shared_prefix_pages)
with a pool small enough that admissions defer and pages recycle, prompts
of several prefill rounds, and no, a page-aligned or an unaligned
shared_prefix; against batch-1 ``generate`` of prefix + prompt (ids
exactly, f32 and int8 pools); and on the hazard ku closes: a finished row
points at scratch before the next decode chunk, so a page handed to a new
request is never written by its former row. The LM is the tiny one of
test_torch_serving.py (2 blocks, d 32, 4/2 heads, RoPE, vocabulary 64) with
4-slot pages.
"""

import flax.linen as flnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ku
from ku.nn.serving import ContinuousBatcher as KuBatcher
from ku_torch.nn import ContinuousBatcher, Transformer, generate
from ku_torch.utility import state_dict_from_tree

VOCAB, D, MAX_LEN, PG = 64, 32, 48, 4
BLOCK = dict(causal=True, rope=True, num_kv_head=2, max_decode_len=MAX_LEN,
             kv_page_size=PG)


class KuLM(flnn.Module):
    num_pages: int | None

    @flnn.compact
    def __call__(self, xs, decode=False, prompt_lengths=None):
        x = xs[0]
        for i in range(2):
            x = ku.Transformer(4, D, 0.0, name=f"block{i}", flash_decode=False,
                               kv_num_pages=self.num_pages, **BLOCK)(
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
def lm():
    rng = np.random.default_rng(31)
    table = rng.normal(size=(VOCAB, D)).astype(np.float32)
    params = jax.jit(lambda k, x: KuLM(None).init(k, [x], decode=True))(
        jax.random.key(5), jnp.zeros((1, 2, D)))["params"]
    t = torch.from_numpy(table)
    return dict(params=params, table=jnp.asarray(table), t=t,
                embed=lambda ids, pos=None: t[ids], readout=lambda y: y @ t.T)


def _port(lm, num_pages, **kw):
    model = LM(kv_num_pages=num_pages, device="cpu", **kw)
    model.load_state_dict(state_dict_from_tree(lm["params"], "cpu"), strict=True)
    return model


def _batcher(lm, num_pages, model_kw=None, **kw):
    return ContinuousBatcher(_port(lm, num_pages, **(model_kw or {})),
                             embed=lm["embed"], readout=lm["readout"],
                             max_decode_len=MAX_LEN, **kw)


def _requests(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=(n,)).astype(np.int64) for n in lengths]


STATS = ("admission_events", "prefill_rounds", "chunks", "wasted_slot_steps",
         "decoded_tokens", "peak_pages_in_use", "shared_prefix_pages")


@pytest.mark.parametrize("prefix_len", [0, 8, 6])  # none, 2 pages, 1.5 pages
def test_paged_batcher_matches_ku(lm, prefix_len):
    """2 slots over 12 pages (11 allocatable): requests need 2..5 pages, so
    some wait for pages, and every later one runs in recycled pages; a
    10-token prompt takes 3 prefill rounds of 4."""
    prompts = _requests(1, (3, 10, 2, 7, 5))
    budgets = [6, 4, 9, 3, 5]
    prefix = _requests(2, (prefix_len,))[0] if prefix_len else None
    kw = dict(num_slots=2, prompt_len=4, chunk=3)
    table = lm["table"]
    want_cb = KuBatcher(KuLM(12), lm["params"], embed=lambda i, p=None: table[i],
                        readout=lambda y: y @ table.T, max_decode_len=MAX_LEN, **kw)
    want = want_cb.serve([p.astype(np.int32) for p in prompts], budgets,
                         shared_prefix=None if prefix is None
                         else prefix.astype(np.int32))
    cb = _batcher(lm, 12, **kw)
    got = cb.serve(prompts, budgets, shared_prefix=prefix)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    for key in STATS:
        assert cb.last_stats.get(key) == want_cb.last_stats.get(key), key
    assert cb.last_stats["prefill_rounds"] > cb.last_stats["admission_events"]
    assert cb.last_stats.get("shared_prefix_pages") == (
        None if prefix is None else -(-prefix_len // PG))


def _alone(lm, model, prompt, budget):
    ids = generate(model, torch.from_numpy(prompt)[None], budget,
                   embed=lm["embed"], readout=lm["readout"])
    return ids[0].numpy()


@pytest.mark.parametrize("model_kw", [{}, dict(kv_cache_dtype="int8")])
def test_paged_batcher_matches_batch1_generate(lm, model_kw):
    """With a 7-token prefix (a 3-token tail copied into each request's
    first page): each output is batch-1 generate of prefix + prompt, and
    admissions deferred for want of pages."""
    prefix = _requests(3, (7,))[0]
    prompts = _requests(4, (5, 1, 9, 4, 6, 2))
    budgets = [7, 5, 4, 8, 3, 6]
    cb = _batcher(lm, 10, model_kw, num_slots=3, prompt_len=4, chunk=(2, 4))
    cb.reset(shared_prefix=prefix)
    for pr, b in zip(prompts, budgets):
        cb.submit(pr, b)
    results, deferred = {}, False
    while not cb.idle:
        cb._admit()  # step() admits too: this shows the state between
        deferred |= bool(cb._queue) and not cb._active.all()
        results.update(cb.step())
    assert deferred
    assert cb.last_stats["peak_pages_in_use"] <= 9
    alone = _port(lm, None, **model_kw)
    for rid, (pr, b) in enumerate(zip(prompts, budgets)):
        np.testing.assert_array_equal(
            results[rid], _alone(lm, alone, np.concatenate([prefix, pr]), b))


def test_reallocated_page_is_never_written_by_its_former_row(lm):
    """Request A finishes and its pages go back to the free list; its row
    points at scratch at once, so the next decode chunk (row 0 dead,
    decoding garbage) leaves those pages as they were. Request B, admitted
    into exactly those pages, emits what it emits alone."""
    cb = _batcher(lm, 7, num_slots=2, prompt_len=4, chunk=2)
    cb.reset()
    a, c, b = _requests(5, (3, 4, 2))
    cb.submit(a, 4)    # 2 pages
    cb.submit(c, 12)   # 4 pages: the pool (6 allocatable) is now full
    assert cb.step() == {}
    pages_a = list(cb._slot_pages[0])
    assert len(pages_a) == 2 and not cb._free_pages
    assert list(cb.step()) == [0]  # A's 4 tokens are done
    assert sorted(cb._free_pages) == sorted(pages_a)
    assert torch.all(cb._table[0] == 0)
    pools = {k: v[pages_a].clone() for k, v in cb._cache.items()
             if k.endswith(("pages_k", "pages_v"))}
    assert cb.step() == {}
    for k, v in pools.items():
        assert torch.equal(cb._cache[k][pages_a], v), k
    cb.submit(b, 4)    # 2 pages: A's
    out = cb.step()
    assert sorted(cb._slot_pages[0]) == sorted(pages_a)
    while not cb.idle:
        out.update(cb.step())
    np.testing.assert_array_equal(out[2], _alone(lm, _port(lm, None), b, 4))


def test_paged_batcher_guards(lm):
    cb = _batcher(lm, 6, num_slots=2, prompt_len=4, chunk=2)
    with pytest.raises(ValueError, match="grow kv_num_pages"):
        cb.serve(_requests(6, (20,)), 20)  # 10 pages of 5 allocatable
    cb.reset(force=True)  # the request that can never fit is still queued
    with pytest.raises(ValueError, match="length >= 2"):
        cb.serve(_requests(6, (2,)), 2, shared_prefix=[1])
    with pytest.raises(ValueError, match="allocatable"):
        cb.serve(_requests(6, (2,)), 2, shared_prefix=list(range(20)))
    with pytest.raises(ValueError, match="overruns"):
        cb.serve(_requests(6, (2,)), 30, shared_prefix=list(range(20)))
    model = _port(lm, 12)
    model.block1.MultiHeadAttention_1.kv_page_size = 8
    with pytest.raises(ValueError, match="disagree"):
        ContinuousBatcher(model, embed=lm["embed"], readout=lm["readout"],
                          max_decode_len=MAX_LEN, num_slots=2,
                          prompt_len=4).reset()
