"""ku_torch's attention and transformer blocks against ku's, on the CPU.

The same numpy-made inputs go through the flax module and its port, with
ku's params carried across by ``state_dict_from_tree`` and loaded with
``strict=True``. Tolerance: f32 rtol/atol 1e-5 (the two frameworks sum in
other orders; nothing here runs long enough to drift further). Also here:
bf16 parameters cross between the packages bit for bit, and the batcher
refuses a mesh that is not a ``DeviceMesh``.
"""

import inspect

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import ku
from ku_torch.kernels.sparse_attention import make_block_mask
from ku_torch.nn import InterferedTransformer, MultiHeadAttention, Transformer
from ku_torch.utility import (
    params_from_numpy,
    params_to_numpy,
    state_dict_from_tree,
    tree_from_state_dict,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port(module, params):
    module.load_state_dict(state_dict_from_tree(params, "cpu"), strict=True)
    return module


def _init(module, *args, **kw):
    """ku's params, initialised under jit (one compile instead of many
    eager dispatches)."""
    return jax.jit(lambda key, *a: module.init(key, *a, **kw))(
        jax.random.key(0), *args)["params"]


def _apply(module):
    return jax.jit(lambda variables, *a, **kw: module.apply(variables, *a, **kw))


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_flat(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def test_bf16_params_cross_bit_for_bit(rng):
    block = ku.Transformer(2, 16, 0.0, causal=True, num_kv_head=1)
    x = jnp.asarray(rng.normal(size=(1, 3, 16)).astype(np.float32))
    params = _init(block, [x])
    bf16 = jax.tree.map(
        lambda a: np.asarray(a).astype(ml_dtypes.bfloat16), params)
    tree = params_from_numpy(bf16, "cpu")
    leaf = tree["MultiHeadAttention_0"]["W_Q"]
    assert leaf.dtype == torch.bfloat16
    back = params_to_numpy(tree)
    for path, want in _flat(bf16).items():
        got = _flat(back)[path]
        assert got.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    # The state-dict route carries them the same way, and a bf16 port module
    # takes them as they are.
    sd = state_dict_from_tree(bf16, "cpu")
    port = Transformer(2, 16, causal=True, num_kv_head=1, device="cpu",
                       dtype=torch.bfloat16)
    port.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(
        port.Dense_0.kernel.detach().view(torch.int16).numpy(),
        bf16["Dense_0"]["kernel"].view(np.int16))


def test_state_dict_round_trip(rng):
    block = ku.Transformer(4, 16, 0.0, causal=True, num_kv_head=2, rope=True)
    x = jnp.asarray(rng.normal(size=(1, 3, 16)).astype(np.float32))
    params = _init(block, [x])
    sd = state_dict_from_tree(params, "cpu")
    assert "MultiHeadAttention_1.W_K" in sd and "LayerNorm_2.scale" in sd
    port = Transformer(4, 16, causal=True, num_kv_head=2, rope=True, device="cpu")
    assert set(port.state_dict()) == set(sd)
    port.load_state_dict(sd, strict=True)
    back = tree_from_state_dict(port.state_dict())
    want, got = _flat(params), _flat(back)
    assert set(want) == set(got)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


@pytest.mark.parametrize("convert", [params_from_numpy, state_dict_from_tree])
def test_converters_put_tensors_on_the_card_unless_asked(convert):
    assert inspect.signature(convert).parameters["device"].default == "cuda"


MHA_CASES = {
    "plain": dict(similarity_type="plain"),
    "scaled": dict(),
    "general": dict(similarity_type="general"),
    "diff_abs": dict(similarity_type="diff_abs"),
    "additive": dict(similarity_type="additive"),
    "mask": dict(use_mask=True),
    "gqa_rope_softcap_causal": dict(num_kv_head=2, rope=True,
                                    logit_softcap=0.5, causal=True),
    "window_sinks": dict(causal=True, window=3, global_prefix=2),
    "segments": dict(causal=True, segments=True),
    "flash_gqa_window_segments": dict(use_flash=True, num_kv_head=1,
                                      causal=True, window=4, segments=True,
                                      rope=True, logit_softcap=2.0),
}


@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_multi_head_attention_matches_ku(rng, case):
    kw = dict(MHA_CASES[case])
    segments = kw.pop("segments", False)
    b, n, d = 2, 7, 16
    q, k, v = (rng.normal(size=(b, n, d)).astype(np.float32) for _ in range(3))
    m = (rng.random((b, 4, n, n)) > 0.3).astype(np.float32)
    seg = np.array([[0, 0, 0, 1, 1, 1, 1], [0, 1, 1, 1, 2, 2, 2]], np.int32)
    call = dict(segment_ids=seg if segments else None)
    layer = ku.nn.MultiHeadAttention(4, 12, 0.0, **kw)
    inputs = [jnp.asarray(a) for a in (q, k, v, m)]
    params = _init(layer, inputs)
    want = _apply(layer)({"params": params}, inputs, **call)
    port = _port(MultiHeadAttention(4, 12, 0.0, d_input=d, device="cpu", **kw),
                 params)
    with torch.no_grad():
        got = port([torch.from_numpy(a) for a in (q, k, v, m)],
                   segment_ids=torch.from_numpy(seg) if segments else None)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_transformer_blocks_match_ku(rng):
    b, n, d = 2, 6, 16
    x = rng.normal(size=(b, n, d)).astype(np.float32)
    emb = rng.normal(size=(b, 8)).astype(np.float32)
    kw = dict(causal=True, num_kv_head=2, rope=True, logit_softcap=3.0)
    block = ku.Transformer(4, d, 0.0, **kw)
    params = _init(block, [jnp.asarray(x)])
    want = _apply(block)({"params": params}, [jnp.asarray(x)])
    port = _port(Transformer(4, d, **kw, device="cpu"), params)
    with torch.no_grad():
        np.testing.assert_allclose(_np(port([torch.from_numpy(x)])),
                                   np.asarray(want), **TOL)

    inter = ku.InterferedTransformer(4, d, 0.0, similarity_type="general")
    inputs = [jnp.asarray(emb), jnp.asarray(x)]
    params = _init(inter, inputs)
    want = _apply(inter)({"params": params}, inputs)
    port = _port(InterferedTransformer(4, d, similarity_type="general",
                                       d_embed=8, device="cpu"), params)
    with torch.no_grad():
        got = port([torch.from_numpy(emb), torch.from_numpy(x)])
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def _decode_both(layer, port, params, chunks, ku_cache=None):
    """Run the same chunks (embeddings, prompt_lengths) through ku and the
    port, comparing outputs and caches after every chunk."""
    step = jax.jit(lambda variables, x, lens: layer.apply(
        variables, [x], decode=True, mutable=["cache"], prompt_lengths=lens))
    cache = {}
    for x, lens in chunks:
        variables = {"params": params, **({"cache": ku_cache} if ku_cache else {})}
        want, mut = step(variables, jnp.asarray(x), lens)
        ku_cache = mut["cache"]
        with torch.no_grad():
            got, cache = port([torch.from_numpy(x)], decode=True, cache=cache,
                              prompt_lengths=None if lens is None
                              else torch.tensor(lens))
        # Ragged chunks: outputs at padding positions are garbage the caller
        # ignores, but the same garbage on both sides, so they are compared.
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        ku_flat = _flat(ku_cache)
        assert set(ku_flat) == set(cache)
        for name, value in ku_flat.items():
            if name.endswith("cache_index"):
                np.testing.assert_array_equal(_np(cache[name]), value)
            else:
                np.testing.assert_allclose(_np(cache[name]), value, **TOL)


def test_transformer_decode_matches_ku_cache(rng):
    """Ragged prefill, a second ragged chunk, then per-token steps through
    the plain paths: outputs and the whole cache dict equal ku's cache
    collection (the uniform prefill is the kernel test's below)."""
    b, d, mx = 3, 16, 24
    kw = dict(causal=True, num_kv_head=2, rope=True, max_decode_len=mx,
              logit_softcap=4.0, flash_decode=False)
    block = ku.Transformer(4, d, 0.0, **kw)
    x0 = rng.normal(size=(b, 5, d)).astype(np.float32)
    params = _init(block, [jnp.asarray(x0)], decode=True)
    port = _port(Transformer(4, d, **kw, device="cpu"), params)
    chunks = [(x0, np.array([5, 2, 4], np.int32)),
              (rng.normal(size=(b, 3, d)).astype(np.float32),
               np.array([3, 1, 2], np.int32))]
    chunks += [(rng.normal(size=(b, 1, d)).astype(np.float32), None)
               for _ in range(3)]
    _decode_both(block, port, params, chunks)


def test_decode_through_both_kernels_matches_ku_interpret(rng):
    """A uniform prefill, a ragged chunk and a token step, with use_flash
    and the flash-decoding read on both sides: ku's Pallas kernels in
    interpret mode, the port's plain kernel versions."""
    b, d, mx = 2, 16, 20
    kw = dict(causal=True, num_kv_head=2, rope=True, max_decode_len=mx,
              use_flash=True, flash_decode=True, logit_softcap=3.0)
    layer = ku.nn.MultiHeadAttention(4, d, 0.0, **kw)
    x0 = rng.normal(size=(b, 6, d)).astype(np.float32)
    inputs = [jnp.asarray(x0)] * 3
    params = _init(layer, inputs, decode=True)
    port = _port(MultiHeadAttention(4, d, **kw, device="cpu"), params)

    class SelfAttention:  # [x] → [x, x, x], as Transformer feeds it
        def __init__(self, mod):
            self.mod = mod

        def apply(self, variables, xs, **a):
            return self.mod.apply(variables, [xs[0]] * 3, **a)

        def __call__(self, xs, **a):
            return self.mod([xs[0]] * 3, **a)

    chunks = [(x0, None),
              (rng.normal(size=(b, 4, d)).astype(np.float32),
               np.array([4, 2], np.int32)),
              (rng.normal(size=(b, 1, d)).astype(np.float32), None)]
    _decode_both(SelfAttention(layer), SelfAttention(port), params, chunks)


def test_features_not_ported_raise():
    from ku_torch.nn import ContinuousBatcher

    block = Transformer(2, 8, causal=True, max_decode_len=8, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):  # the batcher takes a mesh
        ContinuousBatcher(block, embed=None, readout=None, num_slots=2,
                          prompt_len=4, max_decode_len=8, mesh=object())
    # Ported: paged and int8 caches, int8 weights (tests/test_torch_quant.py).
    for kw in (dict(kv_page_size=4), dict(kv_cache_dtype="int8"),
               dict(quant_weights=True), dict(quant_weights="w8a8")):
        Transformer(2, 8, causal=True, max_decode_len=8, device="cpu", **kw)
    x = torch.zeros(1, 3, 8)
    # Ported: the ring cache (tests/test_torch_ring_cache.py).
    ring = MultiHeadAttention(2, 8, causal=True, window=2, max_decode_len=8,
                              device="cpu")
    with torch.no_grad():
        _, cache = ring([x, x, x], decode=True)
    assert cache["cache_pos"].tolist() == [[2, 1]]  # slot s: the last position s + 2k
    # block_mask is ported (tests/test_torch_sparse_*.py): a real mask works.
    mha = MultiHeadAttention(2, 8, causal=True, device="cpu")
    mask = make_block_mask(4, block_q=2, block_k=2, causal=True, window=2,
                           global_prefix=1)
    x4 = torch.zeros(1, 4, 8)
    with torch.no_grad():
        assert mha([x4, x4, x4], block_mask=mask).shape == (1, 4, 8)
    # Gradients through use_flash are ported (tests/test_torch_training.py).
    flash = MultiHeadAttention(2, 8, causal=True, use_flash=True, device="cpu")
    with torch.no_grad():
        assert flash([x, x, x]).shape == (1, 3, 8)


def test_dropout_only_when_not_deterministic():
    torch.manual_seed(0)
    x = torch.randn(2, 5, 8)
    mha = MultiHeadAttention(2, 8, 0.5, causal=True, device="cpu")
    with torch.no_grad():
        plain = MultiHeadAttention(2, 8, 0.0, causal=True, device="cpu")
        plain.load_state_dict(mha.state_dict())
        torch.testing.assert_close(mha([x, x, x]), plain([x, x, x]))
        assert not torch.allclose(mha([x, x, x], deterministic=False),
                                  plain([x, x, x]))
