"""Autoregressive generation over the KV-cache protocol.

Port of ``ku/nn/decoding.py`` (``generate`` and its samplers). The model
contract is ``ku``'s, with the cache explicit: ``model([x], decode=True,
cache=cache(, prompt_lengths=...))`` returns ``(y, cache)`` for x (B, L, d)
(:class:`ku_torch.nn.Transformer` and stacks of it do). The caller supplies
``embed`` (token ids, positions → embeddings) and ``readout`` (model output
→ vocab logits), as in ``ku``.

``ku`` runs the decode loop as one ``lax.scan`` dispatch; here it is a
Python loop of single-token steps under ``torch.no_grad()``. Samplers draw
from a ``torch.Generator`` instead of a ``jax.random`` key, so stochastic
draws differ from ``ku``'s; greedy decoding and ``top_k=1`` do not.
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
