"""Online LM serving: ContinuousBatcher as a server loop, in torch.

Port of ``examples/transformer/transformer_server.py``. An OPEN-LOOP
request stream (arrivals do not wait for completions) runs against the
slot-pool scheduler: requests with ragged prompt lengths and budgets arrive
every ``arrival_every`` scheduling rounds and are admitted into freed slots
mid-decode, over a paged KV cache with a shared system prefix. The report:
latency percentiles in rounds (queueing + decode), throughput, slot
utilization and the pool's footprint. Weights are random (seeded): the demo
is about scheduling, not content.

On the card each decode step reads the pool through the paged decode
kernel (``ku_torch.kernels.decode_attention.decode_attention_paged``).

Run from the repository root: ``python examples_torch/transformer/
transformer_server.py [--device cpu]`` (the card by default).
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

from ku_torch.nn import ContinuousBatcher, Transformer  # noqa: E402


def simulate(num_requests: int = 48, num_slots: int = 8, vocab: int = 64,
             d_model: int = 64, num_head: int = 4, prompt_len: int = 16,
             max_decode_len: int = 96, chunk: int = 8, page: int = 16,
             pool_frac: float = 0.7, arrival_every: int = 1, seed: int = 0,
             verbose: bool = True, device="cuda") -> dict:
    """Run the open-loop serving simulation; returns the report dict."""
    rng = np.random.default_rng(seed)
    mp = -(-max_decode_len // page)
    pool = 1 + int(pool_frac * num_slots * mp)
    table = torch.from_numpy(
        rng.normal(size=(vocab, d_model)).astype(np.float32) * 0.3).to(device)
    block = Transformer(num_head, d_model, 0.0, causal=True,
                        num_kv_head=max(1, num_head // 2),
                        max_decode_len=max_decode_len, kv_page_size=page,
                        kv_num_pages=pool, device=device,
                        generator=torch.Generator(device=device).manual_seed(seed))
    cb = ContinuousBatcher(block, embed=lambda i, p=None: table[i],
                           readout=lambda y: y @ table.T, num_slots=num_slots,
                           prompt_len=prompt_len, max_decode_len=max_decode_len,
                           chunk=chunk)
    prefix = rng.integers(0, vocab, size=(11,)).astype(np.int32)
    cb.reset(shared_prefix=prefix)

    # Workload: ragged prompts (some longer than prompt_len: chunked
    # admission) and ragged budgets.
    plens = rng.integers(2, 2 * prompt_len, size=num_requests)
    budgets = rng.integers(chunk, 4 * chunk, size=num_requests)
    reqs = [rng.integers(0, vocab, size=(p,)).astype(np.int32) for p in plens]

    submitted = 0
    submit_round: dict = {}
    latency: dict = {}
    t0 = time.perf_counter()
    t_warm = tok_warm = None
    rounds = 0
    while submitted < num_requests or not cb.idle:
        while submitted < num_requests and rounds >= submitted * arrival_every:
            rid = cb.submit(reqs[submitted], int(budgets[submitted]))
            submit_round[rid] = rounds
            submitted += 1
        for rid in cb.step():
            latency[rid] = rounds + 1 - submit_round[rid]
        rounds += 1
        if t_warm is None:
            # The steady rate leaves out round 0, which pays the first
            # calls' set-up (the kernels' builds on a fresh checkout).
            t_warm = time.perf_counter()
            tok_warm = cb.last_stats["decoded_tokens"]
    wall = time.perf_counter() - t0
    steady = ((cb.last_stats["decoded_tokens"] - tok_warm)
              / max(time.perf_counter() - t_warm, 1e-9) if rounds > 1 else None)

    st = cb.last_stats
    lat = np.asarray(sorted(latency.values()))
    busy = st["decoded_tokens"] / (st["chunks"] * chunk * num_slots)
    report = {
        "requests": num_requests,
        "generated_tokens": st["decoded_tokens"],
        "rounds": rounds,
        "tokens_per_sec_incl_setup": round(st["decoded_tokens"] / wall, 1),
        "tokens_per_sec": round(steady, 1) if steady is not None else None,
        "latency_rounds_mean": round(float(lat.mean()), 2),
        "latency_rounds_p50": int(np.percentile(lat, 50)),
        "latency_rounds_p95": int(np.percentile(lat, 95)),
        "slot_utilization": round(busy, 3),
        "admissions": st["admission_events"],
        "prefill_rounds": st["prefill_rounds"],
        "pool_pages": pool - 1,
        "dense_equiv_pages": num_slots * mp,
        "peak_pages_in_use": st["peak_pages_in_use"],
        "shared_prefix_pages": st["shared_prefix_pages"],
    }
    if verbose:
        print(f"served {num_requests} requests / {num_slots} slots in {rounds} "
              f"rounds ({wall:.1f}s incl. set-up; steady "
              f"{report['tokens_per_sec']} tokens/sec)")
        print(f"latency (rounds, queue+decode): mean "
              f"{report['latency_rounds_mean']}, p50 {report['latency_rounds_p50']}, "
              f"p95 {report['latency_rounds_p95']}")
        print(f"slot utilization {report['slot_utilization']:.1%}; "
              f"{report['admissions']} admissions, {report['prefill_rounds']} "
              "prefill rounds (long prompts chunk at the fixed shape)")
        print(f"paged pool {report['pool_pages']}/{report['dense_equiv_pages']} "
              f"dense-equivalent pages (page {page}); peak in use "
              f"{report['peak_pages_in_use']} incl. "
              f"{report['shared_prefix_pages']} shared-prefix pages")
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    return simulate(device=args.device)


if __name__ == "__main__":
    main()
