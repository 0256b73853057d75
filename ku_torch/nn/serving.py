"""Continuous batching: iteration-level scheduling over the KV-cache
protocol, dense caches.

Port of ``ku/nn/serving.py``'s ``ContinuousBatcher`` in dense mode. A fixed
pool of batch SLOTS decodes in chunks of single-token steps, each slot at
its own position (per-row ``cache_index``); between chunks the host
collects finished sequences, frees their slots and admits queued requests
into them, without touching the other rows.

- **Admission** prefills only the admitted rows: their cache rows are taken
  out (round 0 starts them from an empty cache), prefilled as a sub-batch
  of right-padded prompts with ``prompt_lengths``, and written back by row
  index. ``ku`` instead prefills every slot with dummy rows and merges; both
  leave a continuing row's cache bit for bit as it was, and here no other
  row is even read. Prompts longer than ``prompt_len`` take several rounds
  (chunked prefill); a round continues from the rows' live cache.
- **Decode** runs ``chunk`` single-token steps over all slots. Finished
  slots keep decoding garbage until the chunk ends (``wasted_slot_steps``).
  ``chunk`` may be a sequence of sizes, picked per round by
  :meth:`ContinuousBatcher._pick_chunk`, as in ``ku``.

Not ported yet: the paged pool and ``shared_prefix`` (paged-only in ``ku``
too: it keeps ``ku``'s ``ValueError``), and ``mesh=``, which raises
``NotImplementedError``.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ku_torch.nn.decoding import _mark_seen, chosen_logprob, greedy


class ContinuousBatcher:
    """A slot-pool serving scheduler over the KV-cache protocol.

    Args:
      model: follows the cache protocol of :func:`ku_torch.nn.generate`
        (``model([x], decode=True, cache=..., prompt_lengths=...)`` →
        ``(y, cache)``), dense caches; ``max_decode_len`` must cover
        prompt + budget + chunk.
      embed: (ids (B, L), positions) → (B, L, d); positions (B, 1) per row
        in decode, (P,) in prefill.
      readout: (B, 1, d) → (B, 1, V) logits.
      num_slots: B, the decode batch width.
      prompt_len: P (>= 2), the right-padded prefill width; longer prompts
        prefill in ceil(len/P) rounds.
      max_decode_len: the model's cache length, for the budget checks.
      chunk: tokens per decode round, an int or a sequence of sizes
        (adaptive; validation uses the largest).
      sampler: (logits, generator(, seen)) → ids; greedy by default.
      return_logprobs: results become (tokens, logprobs) tuples.
      eos_id: a slot frees as soon as its sequence emits it (returned).
      generator: ``torch.Generator`` for stochastic samplers.
      model_kwargs: extra keyword arguments for the model.
      mesh: not ported (raises ``NotImplementedError``).
    """

    def __init__(self, model, *, embed: Callable, readout: Callable,
                 num_slots: int, prompt_len: int, max_decode_len: int,
                 chunk=8, sampler: Callable = greedy,
                 return_logprobs: bool = False, eos_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 model_kwargs: Optional[dict] = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "ContinuousBatcher(mesh=...) is not ported to ku_torch yet; it "
                "comes with the multi-device slice of the port")
        if prompt_len < 2:
            raise ValueError("prompt_len must be >= 2")
        chunks = ((chunk,) if isinstance(chunk, (int, np.integer))
                  else tuple(chunk))
        if not chunks or any(int(c) < 1 for c in chunks):
            raise ValueError("chunk must be >= 1 (or a non-empty sequence of "
                             "sizes >= 1)")
        self._chunks = tuple(sorted({int(c) for c in chunks}))
        self.chunk = self._chunks[-1]
        self.num_slots = num_slots
        self.prompt_len = prompt_len
        self.max_decode_len = max_decode_len
        self.eos_id = eos_id
        self.return_logprobs = return_logprobs
        self._model = model
        self._embed = embed
        self._readout = readout
        self._sampler = sampler
        self._needs_seen = getattr(sampler, "needs_seen", False)
        self._kw = dict(model_kwargs or {})
        self._device = next(model.parameters()).device
        self._generator = (generator if generator is not None else
                           torch.Generator(device=self._device).manual_seed(0))
        self._spec = None  # {cache key: (shape without batch, dtype)}

    # -- device programs ------------------------------------------------

    @torch.no_grad()
    def _prefill(self, cache, prompts, lengths, pos0, seen):
        """Prefill a sub-batch of right-padded prompts; returns (cache,
        first token, its logprob, seen)."""
        n, p = prompts.shape
        dev = self._device
        y, cache = self._model(
            [self._embed(prompts, pos0 + torch.arange(p, device=dev))],
            decode=True, cache=cache, prompt_lengths=lengths, **self._kw)
        y_last = y[torch.arange(n, device=dev), lengths.long() - 1][:, None]
        logits = self._readout(y_last)[:, 0]
        if self._needs_seen:
            if seen is None:
                seen = torch.zeros(n, logits.shape[-1], dtype=torch.bool,
                                   device=dev)
            # This round's prompt piece (padding excluded). The sampled
            # token is marked by the decode step that feeds it.
            valid = torch.arange(p, device=dev)[None] < lengths[:, None]
            rows = torch.arange(n, device=dev)[:, None].expand(n, p)
            seen = seen.clone()
            seen[rows[valid], prompts.long()[valid]] = True
            tok = self._sampler(logits, self._generator, seen)
        else:
            tok = self._sampler(logits, self._generator)
        return cache, tok, self._chosen_lp(logits, tok), seen

    def _chosen_lp(self, logits, tok):
        if not self.return_logprobs:
            return torch.zeros(tok.shape, dtype=torch.float32, device=tok.device)
        return chosen_logprob(logits, tok)

    @torch.no_grad()
    def _decode_chunk(self, chunk, lengths):
        """``chunk`` single-token steps over every slot; returns (B, chunk)
        tokens and logprobs, the pending token of each row updated."""
        tok, lp, seen = self._pending, self._pending_lp, self._seen
        cache = self._cache
        lens = torch.as_tensor(lengths, dtype=torch.int64, device=self._device)
        toks, lps = [], []
        for _ in range(chunk):
            y, cache = self._model([self._embed(tok[:, None], lens[:, None])],
                                   decode=True, cache=cache, **self._kw)
            logits = self._readout(y)[:, 0]
            if self._needs_seen:
                seen = _mark_seen(seen, tok)  # the fed token joins the sequence
                nxt = self._sampler(logits, self._generator, seen)
            else:
                nxt = self._sampler(logits, self._generator)
            toks.append(tok)
            lps.append(lp)
            tok, lp = nxt, self._chosen_lp(logits, nxt)
            lens = lens + 1
        self._cache, self._pending, self._pending_lp, self._seen = \
            cache, tok, lp, seen
        return torch.stack(toks, 1), torch.stack(lps, 1)

    # -- set-up -----------------------------------------------------------

    @torch.no_grad()
    def _build_spec(self):
        """One throwaway one-row prefill discovers the cache's entries, the
        vocabulary width and the cache length."""
        P, dev = self.prompt_len, self._device
        x = self._embed(torch.zeros(1, P, dtype=torch.int64, device=dev),
                        torch.arange(P, device=dev))
        y, cache = self._model([x], decode=True, cache={},
                               prompt_lengths=torch.ones(1, dtype=torch.int32,
                                                         device=dev),
                               **self._kw)
        self._vocab = self._readout(y[:, :1]).shape[-1]
        self._spec = {k: (tuple(v.shape[1:]), v.dtype) for k, v in cache.items()}
        lens = {shape[-1] for k, (shape, _) in self._spec.items()
                if k.endswith("cached_key")}
        real = max(lens) if lens else None
        if real is not None and self.max_decode_len > real:
            raise ValueError(
                f"max_decode_len={self.max_decode_len} exceeds the model's "
                f"actual cache length {real} — size the model's "
                "max_decode_len to cover prompt+budget+chunk")

    # -- online scheduler (submit / step) --------------------------------

    def reset(self, shared_prefix=None, force: bool = False) -> None:
        """(Re)initialise: empty queue and slots, fresh stats. Refuses to
        discard queued or in-flight requests unless ``force=True``.
        ``shared_prefix`` needs a paged cache, as in ``ku``."""
        if self._spec is not None and not self.idle and not force:
            raise RuntimeError("reset() would discard queued/in-flight "
                               "requests — drain with step() first or pass "
                               "force=True")
        if shared_prefix is not None:
            raise ValueError("shared_prefix needs a paged cache (kv_page_size) "
                             "— dense callers can prepend the prefix to each "
                             "prompt or use fork_cache")
        if self._spec is None:
            self._build_spec()
        B = self.num_slots
        self._queue: deque = deque()
        self._next_id = 0
        self._budgets: dict = {}
        self._active = np.zeros(B, bool)
        self._slot_req = [None] * B
        self._slot_toks: list = [[] for _ in range(B)]
        self._slot_lps: list = [[] for _ in range(B)]
        self._lengths = np.zeros(B, np.int64)  # pending token position
        self._cache = self._pending = self._pending_lp = None
        self._seen = (torch.zeros(B, self._vocab, dtype=torch.bool,
                                  device=self._device)
                      if self._needs_seen else None)
        self._stats = {"admission_events": 0, "chunks": 0,
                       "wasted_slot_steps": 0, "decoded_tokens": 0,
                       "prefill_rounds": 0}
        self.last_stats = self._stats

    @property
    def idle(self) -> bool:
        """True when no request is queued or decoding."""
        return (self._spec is None
                or (not self._queue and not self._active.any()))

    def _result(self, s):
        toks = np.asarray(self._slot_toks[s], np.int32)
        if not self.return_logprobs:
            return toks
        return toks, np.asarray(self._slot_lps[s], np.float32)

    def progress(self) -> dict:
        """Tokens emitted so far by every in-flight request ({request_id:
        np.int32 array}, or (tokens, logprobs) tuples)."""
        if self._spec is None:
            return {}
        return {self._slot_req[s]: self._result(s)
                for s in range(self.num_slots) if self._active[s]}

    def _validate(self, prompt, budget, label=""):
        P = self.prompt_len
        if budget < 1:
            raise ValueError(f"max_new_tokens{label} must be >= 1")
        if len(prompt) < 1:
            raise ValueError(f"prompt{label} must be non-empty")
        if len(prompt) + budget + self.chunk > self.max_decode_len:
            raise ValueError(
                f"request{label}: prompt {len(prompt)} + budget {budget} + "
                f"chunk {self.chunk} overruns max_decode_len "
                f"{self.max_decode_len}")
        # The last prefill round writes a full P-wide chunk at its start.
        window = -(-len(prompt) // P) * P
        if window > self.max_decode_len:
            raise ValueError(
                f"request{label}: the padded prefill window (ceil(len/{P})*{P}"
                f" = {window}) overruns max_decode_len {self.max_decode_len} "
                "— grow the model's cache or lower prompt_len")

    def submit(self, prompt, max_new_tokens: int, request_id=None):
        """Enqueue one request (admitted at the next :meth:`step`); returns
        its id (auto-assigned ints unless given)."""
        if self._spec is None:
            self.reset()
        budget = int(max_new_tokens)
        self._validate(prompt, budget)
        if request_id is None:
            request_id = self._next_id
            self._next_id += 1
        elif request_id in self._budgets:
            raise ValueError(f"request_id {request_id!r} is already queued or "
                             "in flight")
        self._budgets[request_id] = budget
        self._queue.append((request_id, np.asarray(prompt, np.int64)))
        return request_id

    def _admit(self):
        """Fill free slots from the queue, prefilling only the admitted rows
        in ceil(len/P) rounds of width P."""
        B, P = self.num_slots, self.prompt_len
        dev = self._device
        free = np.flatnonzero(~self._active)
        if not (self._queue and free.size):
            return False
        admitted: list = []  # (slot, prompt)
        for s in free:
            if not self._queue:
                break
            rid, prompt = self._queue.popleft()
            admitted.append((int(s), prompt))
            self._slot_req[s] = rid
            self._slot_toks[s] = []
            self._slot_lps[s] = []
            self._active[s] = True
            self._lengths[s] = len(prompt)
        if self._cache is None:
            self._cache = {k: torch.zeros((B,) + shape, dtype=dt, device=dev)
                           for k, (shape, dt) in self._spec.items()}
            self._pending = torch.zeros(B, dtype=torch.int64, device=dev)
            self._pending_lp = torch.zeros(B, dtype=torch.float32, device=dev)
        if self._needs_seen:
            self._seen[[s for s, _ in admitted]] = False

        rounds = max(-(-len(pr) // P) for _, pr in admitted)
        for c in range(rounds):
            writers = [(s, pr[c * P:(c + 1) * P], (c + 1) * P >= len(pr))
                       for s, pr in admitted if len(pr) > c * P]
            rows = torch.tensor([s for s, _, _ in writers], device=dev)
            sub = np.zeros((len(writers), P), np.int64)
            for i, (_, piece, _) in enumerate(writers):
                sub[i, :len(piece)] = piece
            sub_ln = torch.tensor([len(piece) for _, piece, _ in writers],
                                  dtype=torch.int32, device=dev)
            # Round 0 starts the rows from an empty cache; later rounds
            # continue from their live rows (earlier chunks live there).
            cache_in = ({} if c == 0 else
                        {k: v[rows] for k, v in self._cache.items()})
            fresh, tok, lp, seen = self._prefill(
                cache_in, torch.from_numpy(sub).to(dev), sub_ln, c * P,
                self._seen[rows] if self._needs_seen else None)
            for k, v in fresh.items():
                self._cache[k][rows] = v
            if self._needs_seen:
                self._seen[rows] = seen
            # The first generated token comes from each row's final chunk.
            done = torch.tensor([d for _, _, d in writers], device=dev)
            self._pending[rows[done]] = tok[done]
            self._pending_lp[rows[done]] = lp[done]
        self._stats["admission_events"] += 1
        self._stats["prefill_rounds"] += rounds
        return True

    def _pick_chunk(self) -> int:
        """The largest size that does not overshoot the tightest remaining
        budget among active rows; the smallest when an ``eos_id`` is set and
        requests are queued (EOS can free a slot on any token)."""
        if len(self._chunks) == 1:
            return self._chunks[0]
        if self._queue and self.eos_id is not None:
            return self._chunks[0]
        remaining = min(
            (self._budgets[self._slot_req[s]] - len(self._slot_toks[s])
             for s in range(self.num_slots) if self._active[s]),
            default=self._chunks[0])
        best = self._chunks[0]
        for c in self._chunks[1:]:
            if c <= max(remaining, self._chunks[0]):
                best = c
        return best

    def step(self) -> dict:
        """One scheduling round: admit what fits, decode one chunk, harvest
        finished slots. Returns {request_id: tokens} for the requests that
        finished this round (empty when none, or when idle)."""
        if self._spec is None or self.idle:
            return {}
        self._admit()
        chunk = self._pick_chunk()
        toks, lps = self._decode_chunk(chunk, self._lengths)
        toks = toks.cpu().numpy()
        lps = lps.cpu().numpy()
        self._lengths += chunk
        self._stats["chunks"] += 1
        finished = {}
        for s in range(self.num_slots):
            if not self._active[s]:
                self._stats["wasted_slot_steps"] += chunk
                continue
            rid = self._slot_req[s]
            for j in range(chunk):
                t = int(toks[s, j])
                self._slot_toks[s].append(t)
                self._slot_lps[s].append(float(lps[s, j]))
                self._stats["decoded_tokens"] += 1
                if ((self.eos_id is not None and t == self.eos_id)
                        or len(self._slot_toks[s]) >= self._budgets[rid]):
                    finished[rid] = self._result(s)
                    del self._budgets[rid]
                    self._active[s] = False
                    self._stats["wasted_slot_steps"] += chunk - 1 - j
                    break
        # Dead rows keep decoding until recycled; keep their positions
        # inside the cache for absolute-position embed hooks.
        self._lengths = np.where(self._active, self._lengths,
                                 np.minimum(self._lengths, self.max_decode_len - 1))
        return finished

    def serve(self, prompts: Sequence[Any], max_new_tokens,
              shared_prefix=None) -> list:
        """Serve a whole workload (:meth:`reset`, :meth:`submit` each
        request, :meth:`step` until idle). Returns each request's tokens
        (or (tokens, logprobs)) in submission order; ``self.last_stats``
        holds the run's counters."""
        n = len(prompts)
        budgets = ([int(max_new_tokens)] * n if np.ndim(max_new_tokens) == 0
                   else [int(b) for b in max_new_tokens])
        if len(budgets) != n:
            raise ValueError("max_new_tokens must be scalar or match "
                             "len(prompts)")
        for i, (pr, b) in enumerate(zip(prompts, budgets)):
            self._validate(pr, b, label=f" {i}")
        self.reset(shared_prefix=shared_prefix)
        results: list = [None] * n
        for i, (pr, b) in enumerate(zip(prompts, budgets)):
            self.submit(pr, b, request_id=i)
        while not self.idle:
            for rid, toks in self.step().items():
                results[rid] = toks
        return results
