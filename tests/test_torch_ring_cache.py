"""ku_torch's ring (StreamingLLM) KV cache against ku's, on the CPU.

The same numpy-seeded inputs and ku's initial weights go through
``ku.MultiHeadAttention`` (jitted) and the port's, at ku's sizes (B 2,
T 23, d 8, window 6): a prefill of ``pre`` tokens into an empty ring (the
banded flash pass with ``use_flash``, run as ku's own test runs it, in
interpret mode) and one token at a time after it, wrapping the ring more
than once. Each step's output and every cache leaf agree with ku's within
1e-5 of the largest entry; ``cache_pos`` and ``cache_index`` are equal.
"""

import jax
import numpy as np
import pytest
import torch

import ku
from ku_torch.nn import ContinuousBatcher, MultiHeadAttention, Transformer
from ku_torch.utility import state_dict_from_tree

B, T, DM, WIN = 2, 23, 8, 6
EXACT = ("cache_pos", "cache_index")


def _close(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.dtype, want.dtype)
    scale = max(float(np.abs(want.astype(np.float64)).max()), 1e-30)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                               rtol=0, atol=1e-5 * scale, err_msg=what)


def _twins(x, **kw):
    """ku's layer and its variables, and the port's layer with them."""
    layer = ku.MultiHeadAttention(2, x.shape[-1], 0.0, causal=True, **kw)
    variables = jax.jit(layer.init)(jax.random.key(0), [x, x, x])
    port = MultiHeadAttention(2, x.shape[-1], 0.0, causal=True, device="cpu", **kw)
    port.load_state_dict(state_dict_from_tree(variables["params"], "cpu"), strict=True)
    return layer, variables, port


def _ku_run(layer, variables, x, pre):
    """ku's outputs and caches: a prefill of x[:, :pre] (or a single token),
    then one token a step."""
    params = variables["params"]

    @jax.jit
    def call(cache, chunk):
        return layer.apply({"params": params, **cache}, [chunk, chunk, chunk],
                           decode=True, mutable=["cache"])

    outs, caches, cache = [], [], {}
    for lo, hi in [(0, pre)] + [(i, i + 1) for i in range(pre, x.shape[1])]:
        y, cache = call(cache, x[:, lo:hi])
        outs.append(np.asarray(y))
        caches.append(jax.tree.map(np.asarray, cache["cache"]))
    return outs, caches


@torch.no_grad()
def _port_run(port, x, pre):
    x = torch.from_numpy(x)
    outs, caches, cache = [], [], {}
    for lo, hi in [(0, pre)] + [(i, i + 1) for i in range(pre, x.shape[1])]:
        chunk = x[:, lo:hi]
        y, cache = port([chunk, chunk, chunk], decode=True, cache=cache)
        outs.append(y)
        caches.append({k: v.clone() for k, v in cache.items()})
    return outs, caches


def _compare(port_run, ku_run):
    (p_outs, p_caches), (k_outs, k_caches) = port_run, ku_run
    for step, (got, want) in enumerate(zip(p_outs, k_outs)):
        _close(got, want, f"output of call {step}")
    for step, (got, want) in enumerate(zip(p_caches, k_caches)):
        assert set(got) == set(want), (step, sorted(got), sorted(want))
        for name, leaf in want.items():
            if name in EXACT:
                np.testing.assert_array_equal(got[name].numpy(), leaf,
                                              err_msg=f"{name} after call {step}")
                assert got[name].dtype == torch.int32
            else:
                _close(got[name], leaf, f"{name} after call {step}")


@pytest.mark.parametrize("gp,hkv,pre,flash", [
    (2, 2, 17, False), (2, 1, 17, False), (1, 2, 5, False), (2, 2, 2, False),
    (0, 2, 17, True),  # flash: the banded prompt pass
    (0, 2, 1, False), (2, 1, 1, False),  # one token at a time from empty
])
def test_ring_prefill_then_decode_matches_ku(gp, hkv, pre, flash):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, DM)).astype(np.float32)
    layer, variables, port = _twins(x, window=WIN, global_prefix=gp,
                                    num_kv_head=hkv, use_flash=flash)
    ku_run = _ku_run(layer, variables, x, pre)
    port_run = _port_run(port, x, pre)
    _compare(port_run, ku_run)
    # The ring holds gp + window slots, slot-major, and the decode equals
    # the full sink + window forward (ku's own check, on the port's forward).
    assert tuple(port_run[1][-1]["cached_key"].shape) == (B, hkv, gp + WIN, DM // 2)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        full = port([xt, xt, xt]).numpy()
    np.testing.assert_allclose(torch.cat(port_run[0], 1).numpy(), full,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("hkv", [2, 1])
def test_int8_ring_matches_ku(hkv):
    """An int8 ring (ku's int8-cache case: T 13, d 16, window 6, 2 sinks):
    int8 leaves, their scales and the positions against ku's."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, 13, 16)).astype(np.float32)
    layer, variables, port = _twins(x, window=6, global_prefix=2, num_kv_head=hkv,
                                    kv_cache_dtype="int8")
    port_run = _port_run(port, x, 7)
    _compare(port_run, _ku_run(layer, variables, x, 7))
    assert port_run[1][-1]["cached_key"].dtype == torch.int8


def test_transformer_ring_with_rope_matches_ku():
    """A Transformer block with RoPE, GQA and sinks over two ring caches,
    scoped as ku's collection is."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 19, 8)).astype(np.float32)
    kw = dict(causal=True, window=5, global_prefix=1, rope=True, num_kv_head=1)
    block = ku.Transformer(2, 8, 0.0, **kw)
    variables = jax.jit(block.init)(jax.random.key(0), [x])
    port = Transformer(2, 8, 0.0, device="cpu", **kw)
    port.load_state_dict(state_dict_from_tree(variables["params"], "cpu"), strict=True)
    step = jax.jit(lambda c, t: block.apply({"params": variables["params"], **c}, [t],
                                            decode=True, mutable=["cache"]))
    y, cache = step({}, x[:, :8])
    cache_t = {}
    with torch.no_grad():
        got, cache_t = port([torch.from_numpy(x[:, :8])], decode=True, cache=cache_t)
        _close(got, y, "prefill")
        for i in range(8, 19):
            y, cache = step(cache, x[:, i:i + 1])
            got, cache_t = port([torch.from_numpy(x[:, i:i + 1])], decode=True,
                                cache=cache_t)
            _close(got, y, f"step {i}")
    flat = {f"{m}/{k}": v for m, leaves in cache["cache"].items() for k, v in leaves.items()}
    assert set(flat) == set(cache_t)
    for name, leaf in flat.items():
        if name.endswith(EXACT):
            np.testing.assert_array_equal(cache_t[name].numpy(), np.asarray(leaf))
        else:
            _close(cache_t[name], leaf, name)


def test_ring_guards():
    """ku's refusals: a ring prefill into a non-empty cache, ragged prompts
    on a ring, pages with a window, and the batcher over a ring."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 6, 8)).astype(np.float32))
    ring = MultiHeadAttention(2, 8, 0.0, causal=True, window=3, global_prefix=1,
                              device="cpu")
    chunk = x[:, :3]
    _, cache = ring([chunk, chunk, chunk], decode=True)
    with pytest.raises(ValueError, match="EMPTY cache"):
        ring([chunk, chunk, chunk], decode=True, cache=cache)
    with pytest.raises(ValueError, match="ragged prefill"):
        ring([chunk, chunk, chunk], decode=True,
             prompt_lengths=torch.tensor([3, 2], dtype=torch.int32))
    with pytest.raises(ValueError, match="ring"):
        MultiHeadAttention(2, 8, causal=True, window=4, kv_page_size=2,
                           device="cpu")([x, x, x], decode=True)
    with pytest.raises(ValueError, match="max_decode_len"):
        MultiHeadAttention(2, 8, causal=True, device="cpu")([x, x, x], decode=True)
    block = Transformer(2, 8, 0.0, causal=True, window=4, device="cpu")
    table = torch.randn(5, 8, generator=torch.Generator().manual_seed(0))
    cb = ContinuousBatcher(block, embed=lambda i, p=None: table[i],
                           readout=lambda y: y @ table.T, num_slots=2,
                           prompt_len=4, max_decode_len=16)
    with pytest.raises(ValueError, match="does not support ring"):
        cb.serve([np.array([1, 2, 3])], [2])
