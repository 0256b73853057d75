"""ku_torch's paged and int8 KV caches on the CPU, against its dense cache and
against ku.

Mirrors tests/test_paged.py on the port: through the page pool (identity
table or a scheduler's), per-token decode and prefill (dense einsum or the
flash kernel's plain version, ragged) equal the dense layout, and greedy
``generate`` emits the dense layout's ids. Then the port's blocks against
ku's on shared params: outputs and every cache leaf after every chunk, for
the int8 cache dense and paged, through the plain reads and through the
kernels (ku's Pallas kernels in interpret mode, the port's plain versions).
f32 tolerances: rtol 1e-6 / atol 1e-8 between the port's own layouts where
the same arithmetic runs over views of another length (ku's own limit in
tests/test_paged.py), 1e-5 where the page read folds in another order and
against ku (two frameworks, sums in other orders); int8 leaves and
cache indices exactly.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ku
from ku_torch.nn import MultiHeadAttention, Transformer, generate
from ku_torch.utility import state_dict_from_tree

TOL = dict(rtol=1e-5, atol=1e-5)


def _mha(dm, **kw):
    return MultiHeadAttention(2, dm, 0.0, causal=True, device="cpu", **kw)


def _twins(dm, **kw):
    """A dense-cache layer and its paged twin (``kw`` holds the paged
    options), with one set of weights."""
    paged_kw = {k: kw.pop(k) for k in ("kv_page_size", "kv_num_pages") if k in kw}
    dense = _mha(dm, **kw)
    paged = _mha(dm, **kw, **paged_kw)
    paged.load_state_dict(dense.state_dict())
    return dense, paged


@torch.no_grad()
def _decode_all(layer, x, cache=None):
    """Per-token decode over x (B, T, d); returns (stacked y, cache)."""
    cache = {} if cache is None else cache
    outs = []
    for i in range(x.shape[1]):
        tok = x[:, i:i + 1]
        y, cache = layer([tok, tok, tok], decode=True, cache=cache)
        outs.append(y)
    return torch.cat(outs, 1), cache


@pytest.mark.parametrize("flash_decode", [None, False])
@pytest.mark.parametrize("kwargs,pg,t", [
    (dict(), 4, 10),
    (dict(), 3, 10),                     # 10 slots, not a page multiple
    (dict(num_kv_head=1), 4, 10),        # MQA
    (dict(kv_cache_dtype="int8"), 4, 10),
    (dict(rope=True), 2, 10),
    (dict(kv_cache_dtype="int8", rope=True), 2, 22),  # 11 pages
])
def test_paged_decode_matches_dense(rng, kwargs, pg, t, flash_decode):
    b, dm = 2, 8
    x = torch.from_numpy(rng.normal(size=(b, t, dm)).astype(np.float32))
    dense, paged = _twins(dm, max_decode_len=t, flash_decode=flash_decode,
                          kv_page_size=pg, **kwargs)
    want, _ = _decode_all(dense, x)
    got, cache = _decode_all(paged, x)
    # The page scan (flash_decode=False) sums an f32 softmax where the dense
    # int8 read sums in the K/V dtype: same values, another order.
    tol = TOL if flash_decode is False else dict(rtol=1e-6, atol=1e-8)
    torch.testing.assert_close(got, want, **tol)
    mp = -(-t // pg)
    assert cache["pages_k"].shape == (b * mp, 2 if "num_kv_head" not in kwargs
                                      else 1, dm // 2, pg)
    assert cache["page_table"].shape == (b, mp)
    assert torch.equal(cache["cache_index"], torch.full((b,), t, dtype=torch.int32))


@pytest.mark.parametrize("flash,qdt,ragged", [
    (False, None, False), (True, None, False), (False, "int8", False),
    (True, "int8", True), (False, None, True), (True, None, True),
])
def test_paged_prefill_matches_dense(rng, flash, qdt, ragged):
    """One prefill chunk, then per-token decode continuing from it."""
    b, t, dm, p = 2, 9, 8, 5
    x = torch.from_numpy(rng.normal(size=(b, t, dm)).astype(np.float32))
    dense, paged = _twins(dm, max_decode_len=16, use_flash=flash,
                          kv_cache_dtype=qdt, kv_page_size=4)
    kw = dict(prompt_lengths=torch.tensor([3, 5])) if ragged else {}
    chunk = x[:, :p]
    with torch.no_grad():
        yw, dcache = dense([chunk] * 3, decode=True, cache={}, **kw)
        yg, pcache = paged([chunk] * 3, decode=True, cache={}, **kw)
    torch.testing.assert_close(yg, yw, rtol=1e-6, atol=1e-7)
    want, _ = _decode_all(dense, x[:, p:], dcache)
    got, _ = _decode_all(paged, x[:, p:], pcache)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("flash_decode", [None, False])
def test_paged_custom_pool_and_tables(rng, flash_decode):
    """A shared pool smaller than B·MP with tables a scheduler assigned
    (page 0 kept as scratch) reproduces the dense outputs and never writes
    page 0."""
    b, t, dm, pg = 2, 8, 8, 4
    x = torch.from_numpy(rng.normal(size=(b, t, dm)).astype(np.float32))
    dense, paged = _twins(dm, max_decode_len=t, kv_page_size=pg,
                          kv_num_pages=1 + b * t // pg, flash_decode=flash_decode)
    want, _ = _decode_all(dense, x)
    tables = {"page_table": torch.tensor([[3, 1], [4, 2]], dtype=torch.int32)}
    got, cache = _decode_all(paged, x, tables)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.all(cache["pages_k"][0] == 0) and torch.all(cache["pages_v"][0] == 0)


def test_paged_writes_past_the_table_end_are_dropped(rng):
    """A ragged prefill whose padded chunk runs past MP·pg: the kept
    positions land, the rest are dropped (ku's table scatter); a per-token
    step past the end changes nothing either."""
    b, dm, pg = 2, 8, 4
    layer = _mha(dm, max_decode_len=8, kv_page_size=pg, kv_num_pages=6)
    tables = {"page_table": torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)}
    x = torch.from_numpy(rng.normal(size=(b, 11, dm)).astype(np.float32))
    with torch.no_grad():
        _, cache = layer([x] * 3, decode=True, cache=dict(tables),
                         prompt_lengths=torch.tensor([11, 2]))
        pools = {k: cache[k].clone() for k in ("pages_k", "pages_v")}
        for k in pools:  # pages 0 and 5 belong to nobody: never written
            assert torch.all(pools[k][0] == 0) and torch.all(pools[k][5] == 0)
        cache["cache_index"] = torch.tensor([8, 9], dtype=torch.int32)
        tok = x[:, :1]
        _, cache = layer([tok] * 3, decode=True, cache=cache)
    for k, v in pools.items():
        assert torch.equal(cache[k], v), k


def test_paged_generate_matches_dense_and_ku(rng):
    vocab, dm, b, p, steps = 11, 8, 2, 4, 6
    table = rng.normal(size=(vocab, dm)).astype(np.float32)
    ids = rng.integers(0, vocab, size=(b, p))
    ku_paged = ku.Transformer(2, dm, 0.0, causal=True,
                              max_decode_len=p + steps + 4, kv_page_size=4)
    params = jax.jit(lambda k, x: ku_paged.init(k, [x]))(
        jax.random.key(0), jnp.asarray(table)[ids])["params"]
    tj = jnp.asarray(table)
    want = np.asarray(ku.nn.generate(ku_paged, params, jnp.asarray(ids, jnp.int32),
                                     steps, embed=lambda i, pos=None: tj[i],
                                     readout=lambda y: y @ tj.T))
    tt = torch.from_numpy(table)
    io = dict(embed=lambda i, pos=None: tt[i], readout=lambda y: y @ tt.T)
    got = {}
    for name, kw in (("dense", {}), ("paged", dict(kv_page_size=4)),
                     ("paged_int8", dict(kv_page_size=4, kv_cache_dtype="int8"))):
        model = Transformer(2, dm, causal=True, max_decode_len=p + steps + 4,
                            device="cpu", **kw)
        model.load_state_dict(state_dict_from_tree(params, "cpu"), strict=True)
        got[name] = generate(model, torch.from_numpy(ids), steps, **io).numpy()
    np.testing.assert_array_equal(got["paged"], got["dense"])
    np.testing.assert_array_equal(got["paged"], want)
    assert got["paged_int8"].shape == (b, steps)


def test_paged_guards(rng):
    dm = 8
    x = torch.from_numpy(rng.normal(size=(2, 4, dm)).astype(np.float32))
    with pytest.raises(ValueError, match="ring"):
        _mha(dm, window=4, kv_page_size=2)([x] * 3)
    with pytest.raises(ValueError, match="kv_num_pages"):
        _mha(dm, max_decode_len=8, kv_num_pages=4)([x] * 3)
    with pytest.raises(ValueError, match="max_decode_len"):
        _mha(dm, kv_page_size=2)([x] * 3, decode=True)
    with pytest.raises(ValueError, match="kv_page_size must be"):
        _mha(dm, max_decode_len=8, kv_page_size=0)([x] * 3, decode=True)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        _mha(dm, max_decode_len=8, kv_cache_dtype="fp8")([x] * 3, decode=True)
    layer = _mha(dm, max_decode_len=8, kv_page_size=4, kv_num_pages=3)
    with torch.no_grad(), pytest.warns(UserWarning, match="ALIASES"):
        _, cache = layer([x] * 3, decode=True)
    with torch.no_grad(), warnings.catch_warnings():
        warnings.simplefilter("error")  # the table exists now: no warning
        layer([x[:, :1]] * 3, decode=True, cache=cache)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_flat(value, path))
        else:
            out[path] = np.asarray(value)
    return out


KU_CASES = {
    "int8_dense_plain": dict(kv_cache_dtype="int8", flash_decode=False),
    "int8_dense_kernels": dict(kv_cache_dtype="int8", use_flash=True,
                               flash_decode=True),
    "paged_plain": dict(kv_page_size=3, flash_decode=False),
    "paged_int8_plain": dict(kv_page_size=4, kv_cache_dtype="int8",
                             flash_decode=False),
    "paged_int8_kernels": dict(kv_page_size=4, kv_cache_dtype="int8",
                               use_flash=True, flash_decode=True),
}


@pytest.mark.parametrize("case", sorted(KU_CASES))
def test_cache_leaves_match_ku(rng, case):
    """A ragged prefill, a second ragged chunk and three per-token steps
    through a Transformer block: outputs and every cache leaf (pools,
    table, int8 values and scales, indices) equal ku's cache collection
    after every chunk."""
    b, d = 3, 16
    kw = dict(causal=True, num_kv_head=2, rope=True, max_decode_len=18,
              logit_softcap=4.0, **KU_CASES[case])
    block = ku.Transformer(4, d, 0.0, **kw)
    x0 = rng.normal(size=(b, 5, d)).astype(np.float32)
    params = jax.jit(lambda k, x: block.init(k, [x], decode=True))(
        jax.random.key(0), jnp.asarray(x0))["params"]
    port = Transformer(4, d, **kw, device="cpu")
    port.load_state_dict(state_dict_from_tree(params, "cpu"), strict=True)
    step = jax.jit(lambda variables, x, lens: block.apply(
        variables, [x], decode=True, mutable=["cache"], prompt_lengths=lens))
    chunks = [(x0, np.array([5, 2, 4], np.int32)),
              (rng.normal(size=(b, 3, d)).astype(np.float32),
               np.array([3, 1, 2], np.int32))]
    chunks += [(rng.normal(size=(b, 1, d)).astype(np.float32), None)
               for _ in range(3)]
    ku_cache, cache = None, {}
    for x, lens in chunks:
        variables = {"params": params, **({"cache": ku_cache} if ku_cache else {})}
        want, mut = step(variables, jnp.asarray(x), lens)
        ku_cache = mut["cache"]
        with torch.no_grad():
            got, cache = port([torch.from_numpy(x)], decode=True, cache=cache,
                              prompt_lengths=None if lens is None
                              else torch.from_numpy(lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        ku_flat = _flat(ku_cache)
        assert set(ku_flat) == set(cache)
        for name, value in ku_flat.items():
            mine = cache[name].numpy()
            assert mine.dtype == value.dtype, name
            if value.dtype in (np.int8, np.int32):
                np.testing.assert_array_equal(mine, value, err_msg=name)
            else:
                np.testing.assert_allclose(mine, value, **TOL, err_msg=name)
