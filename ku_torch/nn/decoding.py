"""Autoregressive generation over the KV-cache protocol.

Port of ``ku/nn/decoding.py``: ``generate`` and its samplers, prefix
caching (``fork_cache``), speculative decoding and beam search. The model
contract is ``ku``'s, with the cache explicit: ``model([x], decode=True,
cache=cache(, prompt_lengths=...))`` returns ``(y, cache)`` for x (B, L, d)
(:class:`ku_torch.nn.Transformer` and stacks of it do). The caller supplies
``embed`` (token ids, positions → embeddings) and ``readout`` (model output
→ vocab logits), as in ``ku``.

``ku`` runs the decode loop as one ``lax.scan`` dispatch (and
speculative decoding's rounds as a ``while_loop``); here they are Python
loops under ``torch.no_grad()``. Samplers draw from a ``torch.Generator``
instead of a ``jax.random`` key, so stochastic draws differ from ``ku``'s;
greedy decoding, ``top_k=1``, greedy speculative decoding and beam search
do not.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch


def chosen_logprob(logits, tok):
    """Raw-model log-softmax probability of each chosen token ((B, V)
    logits, (B,) ids → (B,) f32), whatever the sampler reshaped."""
    return torch.log_softmax(logits.float(), dim=-1).gather(
        1, tok[:, None].long())[:, 0]


def greedy(logits, generator=None):
    """argmax sampler (the generator is unused; kept for one signature)."""
    del generator
    return torch.argmax(logits, dim=-1)


def make_sampler(temperature: float = 1.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 repetition_penalty: Optional[float] = None) -> Callable:
    """A stochastic sampler: softmax at ``temperature`` after optional cuts,
    in the serving order repetition penalty (raw logits) → temperature →
    top-k → top-p, as ``ku.nn.make_sampler``.

    ``repetition_penalty`` (CTRL): for each token already seen, a positive
    logit is divided by the penalty and a negative one multiplied. The
    sampler is then marked ``needs_seen`` and called as
    ``sampler(logits, generator, seen)`` with a (B, V) bool mask;
    :func:`generate` and ``ContinuousBatcher`` thread it."""
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if repetition_penalty is not None and repetition_penalty <= 0:
        raise ValueError("repetition_penalty must be > 0, got "
                         f"{repetition_penalty}")

    def sampler(logits, generator=None, seen=None):
        lg = logits
        if repetition_penalty is not None:
            if seen is None:
                raise ValueError("repetition_penalty sampler called without "
                                 "the seen mask; call sampler(logits, "
                                 "generator, seen)")
            pen = torch.where(lg > 0, lg / repetition_penalty,
                              lg * repetition_penalty)
            lg = torch.where(seen, pen, lg)
        lg = lg / max(temperature, 1e-6)
        if top_k is not None:
            kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
            lg = torch.where(lg < kth, float("-inf"), lg)
        if top_p is not None:
            probs = torch.softmax(lg, dim=-1)
            srt = torch.sort(probs, dim=-1, descending=True).values
            exclusive = torch.cumsum(srt, dim=-1) - srt
            keep = exclusive < top_p
            cutoff = torch.where(keep, srt, float("inf")).amin(dim=-1, keepdim=True)
            lg = torch.where(probs >= cutoff, lg, float("-inf"))
        probs = torch.softmax(lg.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    sampler.needs_seen = repetition_penalty is not None
    return sampler


def _seen_from_prompt(prompt_ids, vocab: int, lens=None):
    """(B, V) bool mask of the tokens in each right-padded prompt; with
    ``lens``, positions at or past a row's length do not count."""
    bsz, p = prompt_ids.shape
    device = prompt_ids.device
    valid = torch.ones(bsz, p, dtype=torch.bool, device=device)
    if lens is not None:
        valid = torch.arange(p, device=device)[None] < lens.to(device)[:, None]
    rows = torch.arange(bsz, device=device)[:, None].expand(bsz, p)
    seen = torch.zeros(bsz, vocab, dtype=torch.bool, device=device)
    seen[rows[valid], prompt_ids.long()[valid]] = True
    return seen


def _mark_seen(seen, tok):
    seen = seen.clone()
    seen[torch.arange(seen.shape[0], device=seen.device), tok.long()] = True
    return seen


@torch.no_grad()
def generate(model, prompt_ids, steps: int, *, embed: Callable,
             readout: Callable, sampler: Callable = greedy,
             generator: Optional[torch.Generator] = None,
             prompt_lengths=None, return_logprobs: bool = False,
             model_kwargs: Optional[dict] = None) -> Any:
    """Generate ``steps`` tokens after a prompt: one prefill of the whole
    prompt, then ``steps - 1`` single-token steps.

    Args:
      model: follows the cache protocol (module docstring); its parameters
        live in it.
      prompt_ids: (B, P) int token ids on the model's device.
      steps: number of tokens to generate (>= 1).
      embed: (ids (B, L), positions) → (B, L, d). Positions are global:
        (P,) for the prompt, then (1,) per step, or (B, 1) per row when
        prompts are ragged.
      readout: (B, 1, d) → (B, 1, V) logits.
      sampler: (logits (B, V), generator(, seen)) → (B,) ids; :func:`greedy`
        or :func:`make_sampler`.
      generator: ``torch.Generator`` for stochastic samplers (seed 0 on the
        prompt's device by default).
      prompt_lengths: optional (B,) true lengths of right-padded prompts:
        each row's first token reads position len_b - 1 and its cache
        resumes at len_b.
      model_kwargs: extra keyword arguments for the model.

    Returns:
      (B, steps) int64 generated ids (prompt excluded); with
      ``return_logprobs=True``, also the (B, steps) f32 log-probabilities
      of the emitted tokens under the model's raw distribution.
    """
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    kw = dict(model_kwargs or {})
    device = prompt_ids.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    bsz, p = prompt_ids.shape
    ragged = prompt_lengths is not None
    x0 = embed(prompt_ids, torch.arange(p, device=device))
    if ragged:
        lens = torch.as_tensor(prompt_lengths, device=device).to(torch.int32)
        y, cache = model([x0], decode=True, cache={}, prompt_lengths=lens, **kw)
        y_last = y[torch.arange(bsz, device=device), lens.long() - 1][:, None]
    else:
        y, cache = model([x0], decode=True, cache={}, **kw)
        y_last = y[:, -1:]
    logits = readout(y_last)[:, 0]
    needs_seen = getattr(sampler, "needs_seen", False)
    seen = None
    if needs_seen:
        seen = _seen_from_prompt(prompt_ids, logits.shape[-1],
                                 lens if ragged else None)
        tok = sampler(logits, generator, seen)
        seen = _mark_seen(seen, tok)
    else:
        tok = sampler(logits, generator)
    toks = [tok]
    lps = [chosen_logprob(logits, tok)] if return_logprobs else None

    for i in range(steps - 1):
        pos = ((lens + i)[:, None] if ragged
               else torch.tensor([p + i], device=device))
        y, cache = model([embed(tok[:, None], pos)], decode=True, cache=cache,
                         **kw)
        logits = readout(y)[:, 0]
        if needs_seen:
            tok = sampler(logits, generator, seen)
            seen = _mark_seen(seen, tok)
        else:
            tok = sampler(logits, generator)
        toks.append(tok)
        if return_logprobs:
            lps.append(chosen_logprob(logits, tok))
    ids = torch.stack(toks, dim=1)
    if not return_logprobs:
        return ids
    return ids, torch.stack(lps, dim=1)


def mask_after_eos(ids, eos_id: int, pad_id: int = 0):
    """Keep each row up to and including its first ``eos_id``, replace the
    rest with ``pad_id``; returns (masked ids, lengths incl. the EOS)."""
    ids = torch.as_tensor(ids)
    is_eos = (ids == eos_id).to(torch.int32)
    seen = torch.cumsum(is_eos, dim=1) - is_eos  # EOS itself not masked
    lengths = torch.where(is_eos.any(dim=1), torch.argmax(is_eos, dim=1) + 1,
                          ids.shape[1])
    return torch.where(seen > 0, pad_id, ids), lengths


def _leaf(key: str) -> str:
    return key.rsplit("/", 1)[-1]


def _reject_paged(cache, what: str):
    """Batch-axis surgery needs every leaf batch-first; a paged cache's pool
    leaves are page-major and its tables alias pool pages, so forked rows
    would write into shared pages. Serve paged caches through ``generate``
    or ``ContinuousBatcher`` instead."""
    if any(_leaf(k) == "pages_k" for k in cache):
        raise ValueError(f"{what} does not support paged KV caches "
                         "(pool leaves are not batch-first)")


def fork_cache(cache, n: int):
    """Prefix caching: each row of a prefilled cache repeated ``n`` times
    along the batch (every leaf is batch-first, ``cache_index`` included),
    so that a shared prefix prefilled once at batch B serves B·n divergent
    continuations. Dense and ring caches only. Returns a new dict."""
    _reject_paged(cache, "fork_cache")
    return {k: v.repeat_interleave(n, dim=0) for k, v in cache.items()}


def _rewind(cache, delta):
    """Every layer's ``cache_index`` rolled back by ``delta`` ((B,) int).
    Free on dense caches: the masks admit only slots below the index, so
    what lies past it stays unseen until it is overwritten."""
    return {k: (v - delta).to(v.dtype) if _leaf(k) == "cache_index" else v
            for k, v in cache.items()}


def _categorical(logits, generator):
    """One draw a row from softmax(logits) (f32)."""
    return torch.multinomial(torch.softmax(logits.float(), dim=-1), 1,
                             generator=generator)[:, 0]


@torch.no_grad()
def speculative_generate(model, draft_model, prompt_ids, steps: int, *,
                         embed: Callable, readout: Callable,
                         draft_embed: Optional[Callable] = None,
                         draft_readout: Optional[Callable] = None,
                         gamma: int = 4, temperature: Optional[float] = None,
                         generator: Optional[torch.Generator] = None,
                         model_kwargs: Optional[dict] = None,
                         draft_model_kwargs: Optional[dict] = None):
    """Speculative decoding, as ``ku.nn.speculative_generate``: a cheap draft
    model proposes ``gamma`` tokens a round, the target verifies them in one
    chunked cache call (a prefill of gamma + 1 tokens at each row's index),
    and both caches roll back by each row's rejections.

    ``temperature=None``: greedy; the output is the target's greedy
    continuation (the accepted proposals are the longest prefix whose
    argmaxes match). ``temperature=T``: speculative sampling; the draft
    samples at T, a proposal x is accepted when u·max(q(x), ε) < p(x), a
    rejection draws from the normalised residual max(p − q, 0), and after a
    fully accepted round (or a degenerate residual) the bonus token comes
    from p, so the output follows the target's sampling at T. Draws come
    from ``generator`` (seed 0 on the prompt's device by default).

    Each round feeds the draft gamma + 1 tokens (the pending token and its
    gamma proposals), so its cache also holds the last proposal and both
    caches rewind by the same count. Uniform prompt lengths; dense or paged
    caches (a ring cannot rewind). Size ``max_decode_len`` on both models
    for prompt + steps + gamma + 1. ``embed`` receives (B, L) positions
    (rows diverge) as well as the prompt's (P,).

    Returns ((B, steps) ids, (B,) f32 mean tokens accepted a round)."""
    kw = dict(model_kwargs or {})
    dkw = dict(draft_model_kwargs or {})
    d_embed = draft_embed if draft_embed is not None else embed
    d_readout = draft_readout if draft_readout is not None else readout
    stochastic = temperature is not None
    temp = max(temperature, 1e-6) if stochastic else 1.0
    device = prompt_ids.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    bsz, p = prompt_ids.shape
    cap = steps + gamma + 1
    eps = 1e-9
    ar = torch.arange(p, device=device)
    y, tcache = model([embed(prompt_ids, ar)], decode=True, cache={}, **kw)
    _, dcache = draft_model([d_embed(prompt_ids, ar)], decode=True, cache={}, **dkw)
    logits0 = readout(y[:, -1:])[:, 0]
    pending = (_categorical(logits0 / temp, generator) if stochastic
               else torch.argmax(logits0, dim=-1))
    buf = torch.zeros(bsz, cap, dtype=torch.int64, device=device)
    buf[:, 0] = pending
    count = torch.ones(bsz, dtype=torch.int64, device=device)
    rounds = 0
    rows = torch.arange(bsz, device=device)
    j = torch.arange(gamma + 1, device=device)
    while int(count.min()) < steps:
        base = p + count - 1  # (B,) global position of the pending token
        # The draft: gamma proposals and one more feed, each step's
        # distribution kept (stochastic acceptance needs q).
        tok, toks, qs = pending, [], []
        for i in range(gamma + 1):
            yd, dcache = draft_model([d_embed(tok[:, None], (base + i)[:, None])],
                                     decode=True, cache=dcache, **dkw)
            lg = d_readout(yd)[:, 0] / temp
            toks.append(tok)
            qs.append(torch.softmax(lg.float(), dim=-1))
            tok = _categorical(lg, generator) if stochastic else torch.argmax(lg, dim=-1)
        chunk = torch.stack(toks, 1)  # (B, gamma+1): pending, d_1..d_gamma
        qdist = torch.stack(qs, 1)  # (B, gamma+1, V)
        # The target verifies every proposal in one chunk.
        yt, tcache = model([embed(chunk, base[:, None] + j[None])], decode=True,
                           cache=tcache, **kw)
        t_logits = readout(yt) / temp  # (B, gamma+1, V)
        d = chunk[:, 1:]
        if stochastic:
            pdist = torch.softmax(t_logits.float(), dim=-1)
            p_d = pdist[:, :gamma].gather(-1, d[..., None])[..., 0]
            q_d = qdist[:, :gamma].gather(-1, d[..., None])[..., 0]
            u = torch.rand(d.shape, generator=generator, device=device)
            ok = (u * q_d.clamp_min(eps) < p_d).to(torch.int64)
            acc = torch.cumprod(ok, dim=1).sum(dim=1)  # (B,) in [0, gamma]
            p_acc, q_acc = pdist[rows, acc], qdist[rows, acc]  # (B, V)
            resid = (p_acc - q_acc).clamp_min(0.0)
            rsum = resid.sum(-1, keepdim=True)
            use_p = (acc[:, None] == gamma) | (rsum <= eps)
            dist = torch.where(use_p, p_acc, resid / rsum.clamp_min(eps))
            bonus = torch.multinomial(dist.clamp_min(1e-30), 1, generator=generator)[:, 0]
        else:
            g = torch.argmax(t_logits, dim=-1)  # (B, gamma+1)
            match = (d == g[:, :-1]).to(torch.int64)
            acc = torch.cumprod(match, dim=1).sum(dim=1)
            bonus = g[rows, acc]
        # Commit d_1..d_acc, then the bonus; what lies past them is
        # overwritten by later rounds. The start is clamped so the round
        # fits (as ku's dynamic_update_slice), for rows already done.
        w = torch.where(j[None] < acc[:, None], torch.cat([d, torch.zeros_like(d[:, :1])], 1),
                        bonus[:, None])
        start = count.clamp(max=cap - gamma - 1)
        buf[rows[:, None], start[:, None] + j[None]] = w
        delta = gamma - acc
        tcache, dcache = _rewind(tcache, delta), _rewind(dcache, delta)
        count = count + acc + 1
        pending = bonus
        rounds += 1
    mean_accepted = (count - 1).float() / max(rounds, 1)
    return buf[:, :steps], mean_accepted


def _top_k(x, k: int):
    """The k largest entries along the last axis and their indices, ties to
    the lower index, as ``jax.lax.top_k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def beam_search(model, prompt_ids, steps: int, *, embed: Callable,
                readout: Callable, beam_size: int,
                model_kwargs: Optional[dict] = None):
    """Fixed-length beam search over the cache protocol, as
    ``ku.nn.beam_search``: the prompt prefills once at batch B, the cache
    forks to B·beam_size rows, and each step gathers every cache leaf by the
    surviving beams' rows (b·K + parent): switching hypotheses is a gather,
    never a recompute. Beams score by their total log-probability; uniform
    prompt lengths, no EOS. ``beam_size`` may exceed the vocabulary: the
    first expansion is padded with −inf hypotheses that are never chosen
    over live ones.

    Returns (ids (B, beam_size, steps), scores (B, beam_size)), best first."""
    kw = dict(model_kwargs or {})
    K = beam_size
    device = prompt_ids.device
    bsz, p = prompt_ids.shape
    y, cache = model([embed(prompt_ids, torch.arange(p, device=device))],
                     decode=True, cache={}, **kw)
    logp = torch.log_softmax(readout(y[:, -1:])[:, 0], dim=-1)  # (B, V)
    vocab = logp.shape[-1]
    if K > vocab:
        pad = torch.full((bsz, K - vocab), float("-inf"), dtype=logp.dtype,
                         device=device)
        scores, tok = _top_k(torch.cat([logp, pad], -1), K)
        tok = torch.where(tok < vocab, tok, 0)
    else:
        scores, tok = _top_k(logp, K)  # (B, K)
    cache = fork_cache(cache, K)  # one row a hypothesis: (B·K, ...)
    toks, parents = [], []
    base = torch.arange(bsz, device=device)[:, None] * K
    for i in range(steps - 1):
        y, cache = model([embed(tok.reshape(-1, 1), torch.tensor([p + i], device=device))],
                         decode=True, cache=cache, **kw)
        logp = torch.log_softmax(readout(y)[:, 0], dim=-1)  # (B·K, V)
        cand = scores[..., None] + logp.reshape(bsz, K, vocab)
        scores, flat = _top_k(cand.reshape(bsz, K * vocab), K)
        parent, nxt = flat // vocab, flat % vocab  # (B, K)
        gidx = (base + parent).reshape(-1)
        cache = {k: v[gidx] for k, v in cache.items()}
        toks.append(tok)
        parents.append(parent)
        tok = nxt
    # Backtrack from the final (sorted) beams along the parent pointers.
    ptr = torch.arange(K, device=device)[None].expand(bsz, K)
    rev = []
    for tok_t, parent_t in zip(reversed(toks), reversed(parents)):
        ptr = parent_t.gather(1, ptr)
        rev.append(tok_t.gather(1, ptr))
    ids = torch.stack(rev[::-1] + [tok], dim=2)  # (B, K, steps)
    return ids, scores
