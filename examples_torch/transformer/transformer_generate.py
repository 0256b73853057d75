"""Autoregressive LM and its serving (periodic-copy task), in torch.

Port of ``examples/transformer/transformer_generate.py``. A small causal
transformer LM is trained on period-P token sequences (the next token is
the one P positions back: the model must attend at lag P), then served six
ways, each with an exactly measurable accuracy (every generated token has
one right value, the cyclic continuation):

1. training through the port's ``Trainer`` (masked cross-entropy: a target
   counts once a full period is visible);
2. ``generate``: the prompt prefills the KV caches in one call, then one
   token a step (greedy);
3. ``beam_search`` (beam 4), whose top beam must track greedy;
4. ``speculative_generate`` with a 1-block draft LM, greedy, whose output
   must equal ``generate``'s (``greedy-exact``);
5. a ``ContinuousBatcher`` serving 64 ragged requests through 8 slots;
6. the same through a paged cache whose pool holds 60 % of the dense
   footprint.

Its conf, ``transformer_generate_conf.json`` beside it, is ku's; set
``nn_arch.kv_cache_dtype`` to "int8" for the int8 cache and
``nn_arch.use_flash`` for the flash prefill. On the card the per-token
reads go through the decode kernels (``ku_torch.kernels.decode_attention``,
dense and paged) and ``use_flash`` prefills through the flash kernel.

Run from the repository root: ``python examples_torch/transformer/
transformer_generate.py [conf] [--device cpu]`` (the card by default).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from ku_torch.core.config import load_config  # noqa: E402
from ku_torch.engine_ext import Trainer, adam  # noqa: E402
from ku_torch.nn import (ContinuousBatcher, Transformer, beam_search,  # noqa: E402
                         generate, speculative_generate)

CONF_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "transformer_generate_conf.json")


def make_dataset(n: int, seq_len: int, period: int, vocab: int, seed: int = 0):
    """Period-``period`` sequences: x[t] = x[t - period] for t >= period."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(0, vocab, size=(n, period))
    reps = -(-seq_len // period)
    return np.tile(pat, (1, reps))[:, :seq_len]


class LMCore(torch.nn.Module):
    """The decode-capable stack (embeddings in, embeddings out), shared by
    training (the full causal forward) and serving (the cache protocol);
    its blocks are ``block_{i}``, as in ku."""

    def __init__(self, d_model: int = 64, num_head: int = 4, num_blocks: int = 2,
                 max_decode_len: int = 32, use_flash: bool = False,
                 kv_cache_dtype=None, kv_page_size=None, kv_num_pages=None, *,
                 device="cuda", generator=None):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block_{i}", Transformer(
                num_head, d_model, 0.0, causal=True, use_flash=use_flash,
                max_decode_len=max_decode_len, kv_cache_dtype=kv_cache_dtype,
                kv_page_size=kv_page_size, kv_num_pages=kv_num_pages,
                device=device, generator=generator))

    def forward(self, xs, decode=False, prompt_lengths=None, cache=None,
                deterministic=True):
        x = xs[0]
        for i in range(self.num_blocks):
            out = getattr(self, f"block_{i}")([x], deterministic=deterministic,
                                              decode=decode, cache=cache,
                                              prompt_lengths=prompt_lengths,
                                              scope=f"block_{i}")
            x, cache = out if decode else (out, cache)
        return (x, cache) if decode else x


class LM(torch.nn.Module):
    """Training wrapper: token and learned position embeddings, the core,
    and the tied readout (logits = output @ embeddingᵀ). ku's names:
    ``tok.weight`` is flax's ``tok/embedding``, then ``pos`` and ``core``."""

    def __init__(self, vocab: int = 16, seq_len: int = 24, d_model: int = 64,
                 num_head: int = 4, num_blocks: int = 2, use_flash: bool = False,
                 kv_cache_dtype=None, *, device="cuda", seed: int = 0):
        super().__init__()
        g = torch.Generator(device=device).manual_seed(seed)
        self.tok = torch.nn.Embedding(vocab, d_model, device=device)
        self.pos = torch.nn.Parameter(torch.empty(seq_len, d_model, device=device))
        with torch.no_grad():  # flax's Embed default N(0, 1/d) and normal(0.02)
            self.tok.weight.normal_(0.0, 1.0 / np.sqrt(d_model), generator=g)
            self.pos.normal_(0.0, 0.02, generator=g)
        self.core = LMCore(d_model, num_head, num_blocks, max_decode_len=seq_len,
                           use_flash=use_flash, kv_cache_dtype=kv_cache_dtype,
                           device=device, generator=g)

    def forward(self, tokens, deterministic: bool = True):
        t = tokens.shape[1]
        x = self.tok(tokens.long()) + self.pos[None, :t]
        return self.core([x], deterministic=deterministic) @ self.tok.weight.T


def masked_xent(period: int):
    """Cross-entropy over the positions whose target a full period
    determines (t >= period - 1), averaged per sequence."""
    def loss(y_true, logits):
        ce = F.cross_entropy(logits.transpose(1, 2), y_true.long(), reduction="none")
        mask = (torch.arange(ce.shape[1], device=ce.device) >= period - 1).float()
        return (ce * mask).sum(1) / mask.sum()
    return loss


def serving_core(lm: LM, arch: dict, device, **kw) -> LMCore:
    """A core with the trained weights and its own cache options."""
    core = LMCore(int(arch["d_model"]), int(arch["num_head"]),
                  lm.core.num_blocks, device=device, **kw)
    core.load_state_dict(lm.core.state_dict(), strict=True)
    return core.eval()


def hooks(lm: LM, seq_len: int):
    """(embed, readout) of a trained LM. Positions arrive as (L,) for a
    prefill and (B, L) for per-row feeds; speculative rounds and the
    batchers' chunks can run past ``seq_len``, so the position index is
    clipped (those tokens are cut from the output)."""
    tab, pos_tab = lm.tok.weight.detach(), lm.pos.detach()

    def embed(i, p):
        pe = pos_tab[torch.as_tensor(p, device=tab.device).clamp(0, seq_len - 1)]
        return tab[i] + (pe[None] if pe.dim() == 2 else pe)

    return embed, (lambda y: y @ tab.T)


def train_lm(arch, hps, x_train, y_train, device, num_blocks, epochs, seed=0):
    model = LM(vocab=int(arch["vocab"]), seq_len=int(arch["seq_len"]),
               d_model=int(arch["d_model"]), num_head=int(arch["num_head"]),
               num_blocks=num_blocks, use_flash=bool(arch.get("use_flash", False)),
               kv_cache_dtype=arch.get("kv_cache_dtype"), device=device, seed=seed)
    trainer = Trainer(model, masked_xent(int(arch["period"])),
                      optimizer=adam(float(hps["lr"])), seed=seed)
    trainer.fit(x_train, y_train, batch_size=int(hps["batch_size"]), epochs=epochs,
                verbose=1 if seed == 0 else 0)
    return model.eval()


def serve_all(lm, draft, arch, device) -> dict:
    """Parts 2-6 on a trained LM (and a trained draft); returns the
    accuracies, the acceptance and the batchers' stats."""
    vocab, seq_len, period = int(arch["vocab"]), int(arch["seq_len"]), int(arch["period"])
    cache_kw = dict(use_flash=bool(arch.get("use_flash", False)),
                    kv_cache_dtype=arch.get("kv_cache_dtype"))
    embed, readout = hooks(lm, seq_len)
    test = make_dataset(256, seq_len, period, vocab, seed=1)
    prompt_len = seq_len // 2
    steps = seq_len - prompt_len
    ids = torch.as_tensor(test[:, :prompt_len], device=device)
    out = {}

    # ---- 2. generate: prefill, then one token a step ----
    core = serving_core(lm, arch, device, max_decode_len=seq_len, **cache_kw)
    t0 = time.time()
    gen = generate(core, ids, steps, embed=embed, readout=readout).cpu().numpy()
    dt = time.time() - t0
    out["acc"] = float((gen == test[:, prompt_len:]).mean())
    print(f"generation accuracy (greedy, {steps} tokens after a "
          f"{prompt_len}-token prompt): {out['acc']:.4f}")
    print(f"serving: {gen.size / dt:.0f} tokens/sec (batch {test.shape[0]}, "
          "prefill + per-token decode)")

    # ---- 3. beam search: the top beam must agree with greedy here ----
    beams, _ = beam_search(core, ids[:32], steps, embed=embed, readout=readout,
                           beam_size=4)
    out["beam_acc"] = float((beams[:, 0].cpu().numpy() == test[:32, prompt_len:]).mean())
    print(f"beam search (beam 4) top-beam accuracy: {out['beam_acc']:.4f}")

    # ---- 4. speculative decoding: a 1-block draft, greedy output equal
    # to generate's (the acceptance rate reported) ----
    core_sp = serving_core(lm, arch, device, max_decode_len=seq_len + 8, **cache_kw)
    dcore = serving_core(draft, arch, device, max_decode_len=seq_len + 8)
    d_embed, d_readout = hooks(draft, seq_len)
    spec, accepted = speculative_generate(
        core_sp, dcore, ids, steps, gamma=3, embed=embed, readout=readout,
        draft_embed=d_embed, draft_readout=d_readout)
    out["exact"] = bool((spec.cpu().numpy() == gen).all())
    out["accepted"] = float(accepted.mean())
    print(f"speculative decoding: greedy-exact={out['exact']}, mean accepted "
          f"{out['accepted']:.2f}/gamma+1=4 per round")

    # ---- 5. continuous batching: ragged requests through 8 slots ----
    chunk = 8
    cb_core = serving_core(lm, arch, device, max_decode_len=seq_len + chunk,
                           kv_cache_dtype=arch.get("kv_cache_dtype"))
    nreq = 64
    plens = np.random.default_rng(3).integers(period, prompt_len + 1, size=nreq)
    reqs = [test[i, :p].astype(np.int32) for i, p in enumerate(plens)]
    buds = [int(seq_len - p) for p in plens]
    cb = ContinuousBatcher(cb_core, embed=embed, readout=readout, num_slots=8,
                           prompt_len=prompt_len, chunk=chunk,
                           max_decode_len=seq_len + chunk)
    t0 = time.time()
    outs = cb.serve(reqs, buds)
    dt = time.time() - t0
    ok = sum((o == test[i, p:p + b]).sum()
             for i, (o, p, b) in enumerate(zip(outs, plens, buds)))
    tot = sum(buds)
    st = cb.last_stats
    out["cb_acc"] = ok / tot
    print(f"continuous batching: {nreq} ragged requests / 8 slots, accuracy "
          f"{ok / tot:.4f}, {tot / dt:.0f} tokens/sec ({st['admission_events']} "
          f"admissions, {st['chunks']} chunks, {st['wasted_slot_steps']} wasted "
          "slot-steps)")

    # ---- 6. paged KV cache: the same workload over a pool at ~60 % of
    # the dense footprint (admission defers, pages recycle) ----
    mdl, pg = seq_len + chunk, 8
    mp = -(-mdl // pg)
    pool = 1 + int(0.6 * 8 * mp)
    paged_core = serving_core(lm, arch, device, max_decode_len=mdl, kv_page_size=pg,
                              kv_num_pages=pool)
    cbp = ContinuousBatcher(paged_core, embed=embed, readout=readout, num_slots=8,
                            prompt_len=prompt_len, chunk=chunk, max_decode_len=mdl)
    outs_p = cbp.serve(reqs, buds)
    ok_p = sum((o == test[i, p:p + b]).sum()
               for i, (o, p, b) in enumerate(zip(outs_p, plens, buds)))
    stp = cbp.last_stats
    out["paged_acc"] = ok_p / tot
    out["peak_pages"] = stp["peak_pages_in_use"]
    print(f"paged continuous batching: pool {pool - 1}/{8 * mp} pages (page {pg}), "
          f"accuracy {ok_p / tot:.4f}, peak in use {stp['peak_pages_in_use']}, "
          f"{stp['admission_events']} admissions")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("conf", nargs="?", default=CONF_PATH)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    conf = load_config(args.conf)
    hps, arch = conf["hps"], conf["nn_arch"]
    seqs = make_dataset(int(hps.get("num_train", 8192)), int(arch["seq_len"]) + 1,
                        int(arch["period"]), int(arch["vocab"]), seed=0)
    x_train, y_train = seqs[:, :-1], seqs[:, 1:]
    start = time.time()
    lm = train_lm(arch, hps, x_train, y_train, args.device,
                  int(arch.get("num_blocks", 2)), int(hps["epochs"]))
    print(f"train time: {time.time() - start:.1f}s")
    draft = train_lm(dict(arch, use_flash=False, kv_cache_dtype=None), hps, x_train,
                     y_train, args.device, 1, max(2, int(hps["epochs"]) // 3), seed=1)
    return serve_all(lm, draft, arch, args.device)


if __name__ == "__main__":
    main()
