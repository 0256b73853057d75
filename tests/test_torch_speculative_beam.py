"""ku_torch's prefix caching, speculative decoding and beam search against
ku's (ku/nn/decoding.py), on the CPU, at ku's own test sizes: Transformer
blocks of width 8 with ku's initial weights, a seeded embedding table tied
to the readout.

Greedy speculative decoding and beam search are deterministic, so their ids
equal ku's (ku jitted); scores and outputs agree within 1e-5 of the largest
entry. Speculative sampling draws from a ``torch.Generator``, so its
distribution is tested as ku tests its own: the first two sampled tokens of
8,192 rows (ku's row count) against the teacher-forced target within
multinomial noise, and the first three with gamma 1, where the third is the
bonus token of a fully accepted round.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ku
from ku.nn import decoding as ku_decoding
from ku_torch.nn import (
    MultiHeadAttention,
    Transformer,
    beam_search,
    fork_cache,
    generate,
    speculative_generate,
)
from ku_torch.nn.decoding import _reject_paged, _rewind
from ku_torch.utility import state_dict_from_tree

DM, B, P = 8, 2, 4


def _close(got, want, what=""):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30), err_msg=what)


def _block(key, mx, x, attn_scale=1.0, **kw):
    """ku's block, its params (the attention projections times
    ``attn_scale``), and the port's block with them."""
    block = ku.Transformer(2, DM, 0.0, causal=True, max_decode_len=mx, **kw)
    params = jax.jit(block.init)(jax.random.key(key), [x])["params"]
    params = {k: ({n: w * attn_scale for n, w in v.items()} if k.startswith("MultiHead")
                  else v) for k, v in params.items()}
    port = Transformer(2, DM, 0.0, causal=True, max_decode_len=mx, device="cpu", **kw)
    port.load_state_dict(state_dict_from_tree(params, "cpu"), strict=True)
    return block, params, port


def _lm(vocab, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(vocab, DM)).astype(np.float32)
    t = torch.from_numpy(table)
    port = dict(embed=lambda i, pos=None: t[i], readout=lambda y: y @ t.T)
    tj = jnp.asarray(table)
    ku_kw = dict(embed=lambda i, pos=None: tj[i], readout=lambda y: y @ tj.T)
    return table, port, ku_kw, rng


def test_fork_cache_matches_ku():
    """A 5-token prefix prefilled once and forked 3 ways, then 3 different
    4-token suffixes as one chunk: outputs and cache leaves against ku's,
    and each suffix's outputs against the full sequence's forward."""
    rng = np.random.default_rng(0)
    pre, n = 5, 3
    x = rng.normal(size=(1, pre, DM)).astype(np.float32)
    sufs = rng.normal(size=(n, 4, DM)).astype(np.float32)
    kw = dict(causal=True, max_decode_len=16, num_kv_head=1)
    layer = ku.MultiHeadAttention(2, DM, 0.0, **kw)
    variables = jax.jit(layer.init)(jax.random.key(0), [x, x, x])

    @jax.jit
    def ku_run(v, x, s):
        _, shared = layer.apply(v, [x, x, x], decode=True, mutable=["cache"])
        forked = {"cache": ku_decoding.fork_cache(shared["cache"], n)}
        return layer.apply({"params": v["params"], **forked}, [s, s, s], decode=True,
                           mutable=["cache"])

    want, want_cache = ku_run(variables, x, sufs)
    port = MultiHeadAttention(2, DM, 0.0, device="cpu", **kw)
    port.load_state_dict(state_dict_from_tree(variables["params"], "cpu"), strict=True)
    xt, st = torch.from_numpy(x), torch.from_numpy(sufs)
    with torch.no_grad():
        _, shared = port([xt, xt, xt], decode=True)
        forked = fork_cache(shared, n)
        got, cache = port([st, st, st], decode=True, cache=forked)
        _close(got, want, "suffix outputs")
        for name, leaf in want_cache["cache"].items():
            _close(cache[name], leaf, name)
        np.testing.assert_array_equal(cache["cache_index"].numpy(), pre + 4)
        assert shared["cache_index"].tolist() == [pre]  # the prefix is untouched
        for i in range(n):
            seq = torch.cat([xt, st[i:i + 1]], 1)
            full = port([seq, seq, seq])
            _close(got[i], full[0, pre:], f"suffix {i} vs its full forward")


def test_rewind_and_reject_paged():
    cache = {"b0/cached_key": torch.zeros(2, 1, 2, 4),
             "b0/cache_index": torch.tensor([5, 7], dtype=torch.int32),
             "b1/cache_index": torch.tensor([5, 7], dtype=torch.int32)}
    out = _rewind(cache, torch.tensor([1, 3]))
    for k in ("b0/cache_index", "b1/cache_index"):
        assert out[k].tolist() == [4, 4] and out[k].dtype == torch.int32
    assert out["b0/cached_key"] is cache["b0/cached_key"]
    assert cache["b0/cache_index"].tolist() == [5, 7]
    forked = fork_cache(cache, 2)
    assert forked["b0/cache_index"].tolist() == [5, 5, 7, 7]
    assert tuple(forked["b0/cached_key"].shape) == (4, 1, 2, 4)

    table, kw, _, rng = _lm(5, 1)
    paged = Transformer(2, DM, 0.0, causal=True, max_decode_len=8, kv_page_size=4,
                        device="cpu")
    ids = torch.zeros(B, 2, dtype=torch.int64)
    _, pcache = paged([kw["embed"](ids)], decode=True)
    for what, call in (("fork_cache", lambda: fork_cache(pcache, 2)),
                       ("fork_cache", lambda: beam_search(paged, ids, 3, beam_size=2, **kw)),
                       ("speculative", lambda: _reject_paged(pcache, "speculative"))):
        with pytest.raises(ValueError, match=f"{what} does not support paged KV caches"):
            call()


# A cache long enough for every gamma below: prompt + steps + 5 + 1. The
# blocks take RoPE and attention weights 25 times ku's initial ones, so
# that what the caches hold, and where, moves the argmax (at ku's scale a
# block's output follows the current token's embedding).
STEPS, MX, SPEC = 9, P + 9 + 6, dict(rope=True, attn_scale=25.0)


@pytest.fixture(scope="module")
def spec_pair():
    table, kw, ku_kw, rng = _lm(7, 0)
    ids = rng.integers(0, 7, size=(B, P)).astype(np.int64)
    x0 = table[ids]
    target = _block(0, MX, x0, **SPEC)
    draft = _block(99, MX, x0, **SPEC)
    want = np.asarray(jax.jit(lambda p, i: ku_decoding.generate(
        target[0], p, i, STEPS, **ku_kw))(target[1], jnp.asarray(ids)))
    return dict(kw=kw, ku_kw=ku_kw, ids=ids, target=target, draft=draft, want=want)


@pytest.mark.parametrize("same_draft,gamma", [(True, 3), (False, 3), (False, 1),
                                              (False, 5)])
def test_speculative_greedy_matches_ku(spec_pair, same_draft, gamma):
    """Greedy speculative decoding equals ku's generate and the port's, with
    the target as its own draft (every proposal accepted) or an unrelated
    draft (rejections); the acceptance diagnostic equals ku's."""
    tb, tp, tport = spec_pair["target"]
    db, dp, dport = spec_pair["target"] if same_draft else spec_pair["draft"]
    ids = torch.from_numpy(spec_pair["ids"])
    got, acc = speculative_generate(tport, dport, ids, STEPS, gamma=gamma, **spec_pair["kw"])
    np.testing.assert_array_equal(got.numpy(), spec_pair["want"])
    np.testing.assert_array_equal(
        generate(tport, ids, STEPS, **spec_pair["kw"]).numpy(), spec_pair["want"])
    ku_ids, ku_acc = jax.jit(lambda a, b, i: ku_decoding.speculative_generate(
        tb, a, db, b, i, STEPS, gamma=gamma, **spec_pair["ku_kw"]))(
            tp, dp, jnp.asarray(spec_pair["ids"]))
    np.testing.assert_array_equal(np.asarray(ku_ids), spec_pair["want"])
    np.testing.assert_allclose(acc.numpy(), np.asarray(ku_acc), rtol=1e-6)
    if same_draft:
        np.testing.assert_allclose(acc.numpy(), gamma + 1.0)
    else:
        assert (acc >= 1.0).all() and (acc <= gamma + 1.0).all()


@pytest.mark.parametrize("steps,gamma", [(2, 2), (3, 1)])
def test_speculative_sampling_matches_target_distribution(steps, gamma):
    """Speculative sampling at T = 1 with an unrelated draft: over 8,192
    rows, the joint distribution of the first tokens matches the
    teacher-forced target within multinomial noise (ku's bound: the
    standard error is at most sqrt(0.25 / 8192) ≈ 0.0055, and 0.025 is
    more than 4.5 of them); the mean accepted lies in [1, gamma + 1]. ku's
    case (2 tokens, gamma 2) sees the first proposal accepted or resampled
    from the residual; with gamma 1 the third token is the bonus drawn from
    p after a fully accepted round."""
    vocab, rows = 5, 8192
    table, kw, _, rng = _lm(vocab, 0)
    prompt = np.array([1, 3])
    mx = 2 + steps + gamma + 1
    x0 = table[prompt][None]
    _, _, target = _block(0, mx, x0, **SPEC)
    _, _, draft = _block(123, mx, x0, **SPEC)
    ids = torch.from_numpy(np.tile(prompt, (rows, 1)))
    # The draft reads out 3 times sharper, so that q stays far from p.
    got, acc = speculative_generate(target, draft, ids, steps, gamma=gamma,
                                    temperature=1.0,
                                    draft_readout=lambda y: 3.0 * kw["readout"](y),
                                    generator=torch.Generator().manual_seed(7), **kw)
    assert got.shape == (rows, steps) and ((got >= 0) & (got < vocab)).all()
    assert (acc >= 1.0).all() and (acc <= gamma + 1.0).all()

    def probs_after(prefix):
        with torch.no_grad():
            y = target([kw["embed"](torch.from_numpy(prefix)[None])])
        return torch.softmax(kw["readout"](y)[0, -1], -1).numpy()

    def joint(prefix, n):  # the teacher-forced probabilities of the next n
        p = probs_after(prefix)
        if n == 1:
            return p
        return np.stack([p[x] * joint(np.append(prefix, x), n - 1) for x in range(vocab)])

    want = joint(prompt, steps)
    emp = np.zeros((vocab,) * steps)
    np.add.at(emp, tuple(got.numpy().T), 1.0 / rows)
    np.testing.assert_allclose(emp, want, atol=0.025)
    assert abs(emp.sum() - 1.0) < 1e-6


def test_beam_search_matches_ku_and_beam1_is_greedy():
    """Beam 4 over a vocabulary of 9: ids equal ku's, scores within 1e-5;
    beam 1 equals greedy generate."""
    vocab, steps = 9, 5
    table, kw, ku_kw, rng = _lm(vocab, 0)
    ids = rng.integers(0, vocab, size=(B, P)).astype(np.int64)
    block, params, port = _block(0, P + steps, table[ids])
    want_ids, want_scores = jax.jit(lambda p, i: ku_decoding.beam_search(
        block, p, i, steps, beam_size=4, **ku_kw))(params, jnp.asarray(ids))
    ids_t = torch.from_numpy(ids)
    got_ids, got_scores = beam_search(port, ids_t, steps, beam_size=4, **kw)
    assert got_ids.shape == (B, 4, steps) and got_scores.shape == (B, 4)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    _close(got_scores, want_scores, "scores")
    assert (got_scores[:, 1:] <= got_scores[:, :-1]).all()  # best first
    beams, scores = beam_search(port, ids_t, steps, beam_size=1, **kw)
    np.testing.assert_array_equal(beams[:, 0].numpy(),
                                  generate(port, ids_t, steps, **kw).numpy())
    assert tuple(scores.shape) == (B, 1)


def test_beam_search_exhaustive_small():
    """beam_size = V² over 3 steps is exhaustive: the top beam is the
    brute-force best of all V³ continuations by teacher-forced
    log-probability, and its score matches."""
    vocab, steps, p = 5, 3, 3
    table, kw, _, rng = _lm(vocab, 0)
    ids = rng.integers(0, vocab, size=(B, p)).astype(np.int64)
    _, _, port = _block(0, p + steps, table[ids])
    beams, scores = beam_search(port, torch.from_numpy(ids), steps,
                                beam_size=vocab ** 2, **kw)
    cands = torch.tensor(list(itertools.product(range(vocab), repeat=steps)))
    seqs = torch.cat([torch.from_numpy(ids).repeat_interleave(len(cands), 0),
                      cands.repeat(B, 1)], 1)
    with torch.no_grad():
        logp = torch.log_softmax(kw["readout"](port([kw["embed"](seqs)])), -1)
    sc = sum(logp[:, p - 1 + t].gather(1, seqs[:, p + t, None])[:, 0] for t in range(steps))
    sc = sc.reshape(B, len(cands))
    best = sc.argmax(1)
    np.testing.assert_array_equal(beams[:, 0].numpy(), cands[best].numpy())
    _close(scores[:, 0], sc.max(1).values, "best score")
    assert (scores[:, 1:] <= scores[:, :-1] + 1e-6).all()
