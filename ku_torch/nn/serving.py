"""Continuous batching: iteration-level scheduling over the KV-cache
protocol, dense or paged caches.

Port of ``ku/nn/serving.py``'s ``ContinuousBatcher``. A fixed pool of batch
SLOTS decodes in chunks of single-token steps, each slot at its own
position (per-row ``cache_index``); between chunks the host collects
finished sequences, frees their slots and admits queued requests into
them, without touching the other rows.

- **Admission** prefills only the admitted rows, as a sub-batch of
  right-padded prompts with ``prompt_lengths``. ``ku`` instead prefills
  every slot with dummy rows and merges; both leave a continuing row's
  cache as it was, and here no other row is even read. Prompts longer than
  ``prompt_len`` take several rounds (chunked prefill); a round continues
  from the rows' live cache. Dense caches: the rows are taken out (round 0
  starts them from an empty cache) and written back by row index.
- **Paged mode** (a model built with ``kv_page_size``, detected from its
  cache): the KV memory is a pool of NP pages, smaller than B × pages per
  sequence, and each request gets only the pages it needs
  (:meth:`ContinuousBatcher._pages_needed`) from a host free list. Page 0
  is scratch: every table entry of a row that is not live, and every entry
  past a row's allocation, points at it. Admission defers in FIFO order
  when the pool is short (and raises when nothing is active and the head of
  the queue can never fit); pages recycle on completion. One (B, MP) table
  tensor is shared by every layer's ``page_table`` entry and kept equal to
  the host's tables: it is rewritten at each admission and as soon as a
  row finishes, so a finished row points at scratch before the next decode
  chunk, and a page handed to a new request is never written by its former
  row. A sub-batch admission passes the pool tensors themselves with the
  admitted rows' table rows: a paged write goes only through the table of
  the row that makes it (:mod:`ku_torch.nn.attention`), and an admitted
  row's table names the shared prefix's full pages (below every position
  it writes), its own pages and scratch, so only the admitted rows' pages
  change. Only ``cache_index`` is copied back.
- ``shared_prefix`` (paged only, as in ``ku``): the prefix is prefilled
  once into pages that never free; each request's table starts with its
  full pages, and its partial tail page is copied into the request's
  first own page at admission.
- **Decode** runs ``chunk`` single-token steps over all slots. Finished
  slots keep decoding garbage until the chunk ends (``wasted_slot_steps``;
  in paged mode into scratch). ``chunk`` may be a sequence of sizes,
  picked per round by :meth:`ContinuousBatcher._pick_chunk`, as in ``ku``.

- ``mesh`` (a ``DeviceMesh``, :func:`ku_torch.dist.make_mesh`): the serving
  replica is the mesh. Over ``model_axis`` the model is split in place for
  head-parallel serving (:func:`ku_torch.dist.parallel.shard_heads_`, ``ku``'s
  ``shard_decode_state``): each rank holds its heads' columns of ``W_Q`` /
  ``W_K`` / ``W_V``, their rows of ``W_multi_head``, its slice of the FFN,
  and its heads of every KV cache (dense, paged, int8); an all-reduce closes
  ``W_multi_head`` and ``Dense_1``, and the decode kernels read the rank's
  heads. When the head counts do not divide the axis it warns and keeps
  the model whole. Over ``data_axis`` the slots split: rank r holds slots
  r·B/D .. (r+1)·B/D − 1 of every per-row cache entry (a page pool stays
  whole on each rank; its rows' tables split), runs the model on them, and
  the logits are gathered, so that every rank samples all B rows with the
  same generator and runs the same schedule. Every rank calls the batcher
  alike, with the same requests.
"""

from __future__ import annotations

import warnings
from collections import deque
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ku_torch.dist.mesh import axis_info, check_mesh
from ku_torch.dist.parallel import shard_heads_
from ku_torch.nn.decoding import _mark_seen, chosen_logprob, greedy

_POOL_LEAVES = ("pages_k", "pages_v", "key_scale_pages", "value_scale_pages")


def _leaf(key: str) -> str:
    return key.rsplit("/", 1)[-1]


class ContinuousBatcher:
    """A slot-pool serving scheduler over the KV-cache protocol.

    Args:
      model: follows the cache protocol of :func:`ku_torch.nn.generate`
        (``model([x], decode=True, cache=..., prompt_lengths=...)`` →
        ``(y, cache)``), dense or paged caches; ``max_decode_len`` must
        cover prefix + prompt + budget + chunk.
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
      mesh: a ``DeviceMesh``; the model is split over it in place (see the
        module's notes).
      model_axis / data_axis / num_head / num_kv_head: the mesh dimensions
        of the heads and of the slots (None: slots not split), and the head
        counts to check against the model axis (``ku``'s names).
    """

    def __init__(self, model, *, embed: Callable, readout: Callable,
                 num_slots: int, prompt_len: int, max_decode_len: int,
                 chunk=8, sampler: Callable = greedy,
                 return_logprobs: bool = False, eos_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 model_kwargs: Optional[dict] = None, mesh=None,
                 model_axis: str = "model", data_axis: Optional[str] = None,
                 num_head: Optional[int] = None, num_kv_head: Optional[int] = None):
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
        self._spec = None  # {cache key: (shape, dtype)}
        self._data = None  # (group, first slot, end) of this rank under data_axis
        if mesh is not None:
            shard_heads_(model, check_mesh(mesh), model_axis, num_head, num_kv_head)
            if data_axis is not None and axis_info(mesh, data_axis)[1] > 1:
                group, world, rank = axis_info(mesh, data_axis)
                if num_slots % world:
                    raise ValueError(f"num_slots {num_slots} does not divide over the "
                                     f"{world} ranks of {data_axis!r}")
                part = num_slots // world
                self._data = (group, rank * part, (rank + 1) * part)

    # -- device programs ------------------------------------------------

    def _gather_logits(self, logits, mine, n):
        """Under ``data_axis``: the (n, V) logits of a batch whose rows
        ``mine`` this rank computed, each row from the rank that holds it (a
        sum over the group of buffers that are zero elsewhere, exact)."""
        full = torch.zeros(n, self._vocab, dtype=logits.dtype if logits is not None
                           else self._logit_dtype, device=self._device)
        if logits is not None:
            full[mine] = logits
        dist.all_reduce(full, group=self._data[0])
        return full

    @torch.no_grad()
    def _prefill(self, cache, prompts, lengths, pos0, seen, mine=None):
        """Prefill a sub-batch of right-padded prompts; returns (cache,
        first token, its logprob, seen). ``mine`` (under ``data_axis``): the
        rows this rank holds, which alone it runs through the model, the
        logits of all rows gathered."""
        n, p = prompts.shape
        dev = self._device
        logits = None
        run = mine is None or bool(mine.any())
        if run:
            pr, ln = (prompts, lengths) if mine is None else (prompts[mine], lengths[mine])
            y, cache = self._model(
                [self._embed(pr, pos0 + torch.arange(p, device=dev))],
                decode=True, cache=cache, prompt_lengths=ln, **self._kw)
            y_last = y[torch.arange(len(pr), device=dev), ln.long() - 1][:, None]
            logits = self._readout(y_last)[:, 0]
        if mine is not None:
            logits = self._gather_logits(logits, mine, n)
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
        lo, hi = (0, self.num_slots) if self._data is None else self._data[1:]
        toks, lps = [], []
        for _ in range(chunk):
            y, cache = self._model([self._embed(tok[lo:hi, None], lens[lo:hi, None])],
                                   decode=True, cache=cache, **self._kw)
            logits = self._readout(y)[:, 0]
            if self._data is not None:
                logits = self._gather_logits(logits, slice(lo, hi), self.num_slots)
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
        """One throwaway prefill of all B slots discovers the cache's entries
        and shapes, the vocabulary width and the cache geometry (dense
        length, or pool pages, page size and table width). It is a uniform
        prefill, so that a ring cache gets as far as showing its
        ``cache_pos`` entry, which is refused here with ``ku``'s message."""
        P, dev = self.prompt_len, self._device
        B = self.num_slots if self._data is None else self._data[2] - self._data[1]
        x = self._embed(torch.zeros(B, P, dtype=torch.int64, device=dev),
                        torch.arange(P, device=dev))
        with warnings.catch_warnings():
            # The identity table's aliasing warning does not apply: the
            # scheduler writes every table before real use.
            warnings.filterwarnings("ignore", message=".*ALIASES.*")
            y, cache = self._model([x], decode=True, cache={}, **self._kw)
        if any(_leaf(k) == "cache_pos" for k in cache):
            raise ValueError(
                "ContinuousBatcher does not support ring (window) caches — "
                "their slot contents depend on global position history and "
                "cannot be row-merged")
        logits = self._readout(y[:, :1])
        self._vocab, self._logit_dtype = logits.shape[-1], logits.dtype
        self._spec = {k: (tuple(v.shape), v.dtype) for k, v in cache.items()}
        pools = {shape[0::3] for k, (shape, _) in self._spec.items()
                 if _leaf(k) == "pages_k"}  # (NP, Hkv, D, pg): slots minor
        mps = {shape[1] for k, (shape, _) in self._spec.items()
               if _leaf(k) == "page_table"}
        self._paged = bool(pools or mps)
        if self._paged:
            if len(pools) != 1 or len(mps) != 1:
                raise ValueError(f"paged layers disagree on pool geometry: "
                                 f"pools (pages, page size) {pools}, table "
                                 f"widths {mps} — the scheduler drives one "
                                 "shared page assignment")
            (self._n_pages, self._page), = pools
            self._mp = mps.pop()
            real = self._mp * self._page
        else:
            lens = {shape[-1] for k, (shape, _) in self._spec.items()
                    if _leaf(k) == "cached_key"}
            real = max(lens) if lens else None
        # A larger declaration would let the overrun guard pass requests
        # whose writes clamp (dense) or drop (paged) past the real cache.
        if real is not None and self.max_decode_len > real:
            raise ValueError(
                f"max_decode_len={self.max_decode_len} exceeds the model's "
                f"actual cache length {real} — size the model's "
                "max_decode_len to cover prompt+budget+chunk")

    def _new_cache(self):
        """A zero cache for all slots (this rank's, under ``data_axis``);
        every layer's page table is the one shared table tensor (its rows of
        this rank's slots)."""
        dev = self._device
        table = getattr(self, "_table", None)
        if table is not None and self._data is not None:
            table = table[self._data[1]:self._data[2]]
        return {k: (table if _leaf(k) == "page_table"
                    else torch.zeros(shape, dtype=dt, device=dev))
                for k, (shape, dt) in self._spec.items()}

    def _push_tables(self):
        """The host's tables onto the device table (read by every layer)."""
        self._table.copy_(torch.from_numpy(self._tables))

    def _mine(self, rows):
        """(which of the slots ``rows`` this rank holds, their indices in its
        cache) under ``data_axis``; (None, rows) without it."""
        if self._data is None:
            return None, rows
        _, lo, hi = self._data
        mine = (rows >= lo) & (rows < hi)
        return mine, rows[mine] - lo

    def _sub_cache(self, rows, pos0, first_round, split=True):
        """The cache a sub-batch prefill of slots ``rows`` runs on. Dense: the
        rows' own entries (nothing in round 0). Paged: the pool tensors
        themselves, the rows' table rows, and cache indices at ``pos0``.
        Under ``data_axis`` (and ``split``), this rank's rows of them."""
        mine, local = self._mine(rows) if split else (None, rows)
        if not self._paged:
            return {} if first_round else {k: v[local] for k, v in self._cache.items()}
        if mine is not None:
            rows = rows[mine]
        sub_table = self._table[rows]
        index = torch.full((len(rows),), pos0, dtype=torch.int32,
                           device=self._device)
        return {k: (v if _leaf(k) in _POOL_LEAVES else
                    sub_table if _leaf(k) == "page_table" else index)
                for k, v in self._cache.items()}

    # -- online scheduler (submit / step) --------------------------------

    def reset(self, shared_prefix=None, force: bool = False) -> None:
        """(Re)initialise: empty queue and slots, fresh stats, and, with
        ``shared_prefix`` (paged mode only, length >= 2), one prefill of the
        prefix into shared pages that every later request's table names.
        Refuses to discard queued or in-flight requests unless
        ``force=True``."""
        if self._spec is not None and not self.idle and not force:
            raise RuntimeError("reset() would discard queued/in-flight "
                               "requests — drain with step() first or pass "
                               "force=True")
        if self._spec is None:
            self._build_spec()
        B, dev = self.num_slots, self._device
        self._queue: deque = deque()
        self._next_id = 0
        self._budgets: dict = {}
        self._active = np.zeros(B, bool)
        self._slot_req = [None] * B
        self._slot_toks: list = [[] for _ in range(B)]
        self._slot_lps: list = [[] for _ in range(B)]
        self._lengths = np.zeros(B, np.int64)  # pending token position
        self._cache = self._pending = self._pending_lp = None
        self._seen = (torch.zeros(B, self._vocab, dtype=torch.bool, device=dev)
                      if self._needs_seen else None)
        # The seen row every admitted slot restarts from (the prefix's tokens).
        self._base_seen = (torch.zeros(self._vocab, dtype=torch.bool, device=dev)
                           if self._needs_seen else None)
        self._stats = {"admission_events": 0, "chunks": 0,
                       "wasted_slot_steps": 0, "decoded_tokens": 0,
                       "prefill_rounds": 0}
        self.last_stats = self._stats
        self._plen_pre, self._n_shared_full = 0, 0
        self._shared_ids, self._prefix_tail_page = [], None
        if self._paged:
            # Page 0 is the scratch target; 1..NP-1 are allocatable.
            self._free_pages = deque(range(1, self._n_pages))
            self._slot_pages: list = [[] for _ in range(B)]
            self._tables = np.zeros((B, self._mp), np.int32)
            self._table = torch.zeros((B, self._mp), dtype=torch.int32, device=dev)
            self._stats["peak_pages_in_use"] = 0
        if shared_prefix is not None:
            self._install_prefix(np.asarray(shared_prefix, np.int64))

    @torch.no_grad()
    def _install_prefix(self, prefix):
        if not self._paged:
            raise ValueError("shared_prefix needs a paged cache (kv_page_size) "
                             "— dense callers can prepend the prefix to each "
                             "prompt or use fork_cache")
        n = len(prefix)
        if n < 2:
            raise ValueError("shared_prefix must have length >= 2")
        n_pre = -(-n // self._page)
        # The prefix pages never free: at least one must remain for requests.
        if n_pre + 1 > self._n_pages - 1:
            raise ValueError(f"shared prefix needs {n_pre} pages and at least "
                             "one request page, but the pool has "
                             f"{self._n_pages - 1} allocatable")
        self._plen_pre = n
        self._n_shared_full = n // self._page
        self._shared_ids = [self._free_pages.popleft() for _ in range(n_pre)]
        if n % self._page:
            self._prefix_tail_page = self._shared_ids[self._n_shared_full]
        self._start_cache()
        # Prefill the prefix once, through a one-row table of its pages.
        self._tables[0, :n_pre] = self._shared_ids
        self._push_tables()
        dev = self._device
        # Every rank writes the prefix into its own whole pool.
        self._prefill(self._sub_cache(torch.tensor([0], device=dev), 0, True, split=False),
                      torch.from_numpy(prefix)[None].to(dev),
                      torch.tensor([n], dtype=torch.int32, device=dev), 0, None)
        self._tables[0] = 0  # row 0 is not a request
        self._push_tables()
        if self._needs_seen:
            self._base_seen[torch.from_numpy(prefix).to(dev)] = True
        self._stats["shared_prefix_pages"] = n_pre

    def _start_cache(self):
        B, dev = self.num_slots, self._device
        self._cache = self._new_cache()
        self._pending = torch.zeros(B, dtype=torch.int64, device=dev)
        self._pending_lp = torch.zeros(B, dtype=torch.float32, device=dev)

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

    def _validate(self, prompt, budget, plen_pre, label=""):
        P = self.prompt_len
        if budget < 1:
            raise ValueError(f"max_new_tokens{label} must be >= 1")
        if len(prompt) < 1:
            raise ValueError(f"prompt{label} must be non-empty")
        if plen_pre + len(prompt) + budget + self.chunk > self.max_decode_len:
            raise ValueError(
                f"request{label}: prefix {plen_pre} + prompt {len(prompt)} + "
                f"budget {budget} + chunk {self.chunk} overruns max_decode_len "
                f"{self.max_decode_len}")
        # The last prefill round writes a full P-wide chunk at its start.
        window = plen_pre + -(-len(prompt) // P) * P
        if window > self.max_decode_len:
            raise ValueError(
                f"request{label}: the padded prefill window (prefix {plen_pre} "
                f"+ ceil(len/{P})*{P} = {window}) overruns max_decode_len "
                f"{self.max_decode_len} — grow the model's cache or lower "
                "prompt_len")

    def submit(self, prompt, max_new_tokens: int, request_id=None):
        """Enqueue one request (admitted at the next :meth:`step`); returns
        its id (auto-assigned ints unless given)."""
        if self._spec is None:
            self.reset()
        budget = int(max_new_tokens)
        self._validate(prompt, budget, self._plen_pre)
        if request_id is None:
            request_id = self._next_id
            self._next_id += 1
        elif request_id in self._budgets:
            raise ValueError(f"request_id {request_id!r} is already queued or "
                             "in flight")
        self._budgets[request_id] = budget
        self._queue.append((request_id, np.asarray(prompt, np.int64)))
        return request_id

    def _pages_needed(self, plen, budget):
        """Own pages a request writes: its prompt and budget rounded up to
        whole chunks, or its padded prefill window, past the prefix's full
        pages."""
        P = self.prompt_len
        written = max(
            self._plen_pre + plen + -(-budget // self.chunk) * self.chunk,
            self._plen_pre + -(-plen // P) * P)
        return -(-written // self._page) - self._n_shared_full

    @torch.no_grad()
    def _admit(self):
        """Fill free slots from the queue (paged: while the pool has the
        pages), prefilling only the admitted rows in ceil(len/P) rounds of
        width P."""
        B, P, dev = self.num_slots, self.prompt_len, self._device
        paged, plen_pre = self._paged, self._plen_pre
        free = np.flatnonzero(~self._active)
        if not (self._queue and free.size):
            return False
        admitted: list = []  # (slot, prompt)
        for s in free:
            if not self._queue:
                break
            rid, prompt = self._queue[0]
            if paged:
                need = self._pages_needed(len(prompt), self._budgets[rid])
                if need > len(self._free_pages):
                    break  # defer; FIFO order kept
                alloc = [self._free_pages.popleft() for _ in range(need)]
                self._slot_pages[s] = alloc
                nf = self._n_shared_full
                self._tables[s] = 0
                self._tables[s, :nf] = self._shared_ids[:nf]
                self._tables[s, nf:nf + need] = alloc
            self._queue.popleft()
            admitted.append((int(s), prompt))
            self._slot_req[s] = rid
            self._slot_toks[s] = []
            self._slot_lps[s] = []
            self._active[s] = True
            self._lengths[s] = plen_pre + len(prompt)
        if paged and not admitted and not self._active.any():
            rid, prompt = self._queue[0]
            allocatable = (self._n_pages - 1
                           - self._stats.get("shared_prefix_pages", 0))
            raise ValueError(
                f"request {rid} needs "
                f"{self._pages_needed(len(prompt), self._budgets[rid])} pages "
                f"but the pool only has {allocatable} allocatable (after the "
                "shared prefix) — grow kv_num_pages")
        if not admitted:
            return False
        if self._cache is None:
            self._start_cache()
        if self._needs_seen:
            self._seen[[s for s, _ in admitted]] = self._base_seen
        if paged:
            self._push_tables()
            self._stats["peak_pages_in_use"] = max(
                self._stats["peak_pages_in_use"],
                sum(len(p) for p in self._slot_pages)
                + self._stats.get("shared_prefix_pages", 0))
            if self._prefix_tail_page is not None:
                # Each request's private copy of the prefix's partial page,
                # which its own writes extend.
                dst = torch.tensor([self._slot_pages[s][0] for s, _ in admitted],
                                   device=dev)
                for k, v in self._cache.items():
                    if _leaf(k) in _POOL_LEAVES:
                        v[dst] = v[self._prefix_tail_page].clone()

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
            pos0 = plen_pre + c * P
            mine, local = self._mine(rows)
            fresh, tok, lp, seen = self._prefill(
                self._sub_cache(rows, pos0, c == 0),
                torch.from_numpy(sub).to(dev), sub_ln, pos0,
                self._seen[rows] if self._needs_seen else None, mine)
            for k, v in fresh.items():
                # Paged pools were written in place; tables are the host's.
                if not paged or _leaf(k) == "cache_index":
                    self._cache[k][local] = v
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
                    if self._paged:  # recycle; the row now points at scratch
                        self._free_pages.extend(self._slot_pages[s])
                        self._slot_pages[s] = []
                        self._tables[s] = 0
                    break
        if self._paged and finished:
            self._push_tables()
        # Dead rows keep decoding until recycled; keep their positions
        # inside the cache for absolute-position embed hooks.
        self._lengths = np.where(self._active, self._lengths,
                                 np.minimum(self._lengths, self.max_decode_len - 1))
        return finished

    def serve(self, prompts: Sequence[Any], max_new_tokens,
              shared_prefix=None) -> list:
        """Serve a whole workload (:meth:`reset`, :meth:`submit` each
        request, :meth:`step` until idle). ``shared_prefix``: tokens every
        request's sequence starts with (paged mode only; each output
        continues prefix + prompt). Returns each request's tokens (or
        (tokens, logprobs)) in submission order; ``self.last_stats`` holds
        the run's counters (admission_events, prefill_rounds, chunks,
        wasted_slot_steps, decoded_tokens; paged mode adds
        peak_pages_in_use and, with a prefix, shared_prefix_pages)."""
        n = len(prompts)
        budgets = ([int(max_new_tokens)] * n if np.ndim(max_new_tokens) == 0
                   else [int(b) for b in max_new_tokens])
        if len(budgets) != n:
            raise ValueError("max_new_tokens must be scalar or match "
                             "len(prompts)")
        plen_pre = 0 if shared_prefix is None else len(shared_prefix)
        for i, (pr, b) in enumerate(zip(prompts, budgets)):
            self._validate(pr, b, plen_pre, label=f" {i}")
        self.reset(shared_prefix=shared_prefix)
        results: list = [None] * n
        for i, (pr, b) in enumerate(zip(prompts, budgets)):
            self.submit(pr, b, request_id=i)
        while not self.idle:
            for rid, toks in self.step().items():
                results[rid] = toks
        return results
