"""ku_torch's int8 weight quantization against ku's (ku/nn/quant.py), on the
CPU.

``quantize_weights`` of the same float weights gives ku's int8 leaves and
scales bit for bit, and they carry across ``variables_from_module`` /
``state_dict_from_tree`` unchanged. ``QuantDense``, ``int8_act_matmul`` and
the quantized ``Transformer`` (forward, and decode over dense, int8 and
paged caches; weight-only and W8A8) agree with ku (jitted) within 1e-5 of
the largest entry. ku's validation errors are reproduced.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ku
from ku.nn import quant as ku_quant
from ku_torch.nn import QuantDense, Transformer, int8_act_matmul, quantize_weights
from ku_torch.utility import state_dict_from_tree, variables_from_module

D, T = 32, 12


def _close(got, want, what=""):
    want = np.asarray(want, np.float64)
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float64))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30), err_msg=what)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def block_pair():
    """ku's float block's params with one all-zero FFN column, ku's
    quantized params from them, and the port's float and quantized blocks."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, T, D)).astype(np.float32)
    kw = dict(num_head=4, d_output=D, dropout_rate=0.0, causal=True, num_kv_head=2,
              max_decode_len=T)
    fparams = jax.jit(ku.Transformer(**kw).init)(jax.random.key(0), [x])["params"]
    fparams = jax.tree.map(np.array, fparams)
    fparams["Dense_1"]["kernel"][:, 3] = 0.0  # an all-zero column: scale 1
    template = jax.jit(ku.Transformer(quant_weights=True, **kw).init)(
        jax.random.key(0), [x])["params"]
    qparams = jax.tree.map(np.asarray, ku_quant.quantize_weights(fparams, template))
    port_f = Transformer(device="cpu", **kw)
    port_f.load_state_dict(state_dict_from_tree(fparams, "cpu"), strict=True)
    return dict(x=x, kw=kw, fparams=fparams, qparams=qparams, port_f=port_f)


def _port_quant(pair, quant, **extra):
    model = Transformer(quant_weights=quant, device="cpu", **pair["kw"], **extra)
    model.load_state_dict(quantize_weights(pair["port_f"].state_dict(), model), strict=True)
    return model


def test_quantize_weights_bit_for_bit_and_round_trip(block_pair):
    port_q = _port_quant(block_pair, True)
    want = _flat(block_pair["qparams"])
    got = {k: v.numpy() for k, v in port_q.state_dict().items()}
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert got[name].dtype == leaf.dtype, name
        np.testing.assert_array_equal(got[name], leaf, err_msg=name)
    assert got["Dense_1.kernel_scale"][3] == 1.0 and not got["Dense_1.kernel"][:, 3].any()
    assert port_q.MultiHeadAttention_0.W_Q.dtype == torch.int8
    assert not any(p.requires_grad for n, p in port_q.named_parameters() if n.endswith("_scale"))
    # ku's trees as state dicts (a template given as one) give the same leaves.
    from_ku = quantize_weights(state_dict_from_tree(block_pair["fparams"], "cpu"),
                               state_dict_from_tree(block_pair["qparams"], "cpu"))
    assert set(from_ku) == set(want)
    for name, leaf in from_ku.items():
        np.testing.assert_array_equal(leaf.numpy(), want[name], err_msg=name)
    # ku's variables load as they are and come back bit for bit.
    loaded = Transformer(quant_weights=True, device="cpu", **block_pair["kw"])
    loaded.load_state_dict(state_dict_from_tree(block_pair["qparams"], "cpu"), strict=True)
    back = _flat(variables_from_module(loaded)["params"])
    for name, leaf in want.items():
        assert back[name].dtype == leaf.dtype
        np.testing.assert_array_equal(back[name], leaf, err_msg=name)


@pytest.mark.parametrize("act_quant", [False, True])
def test_quant_dense_matches_ku(act_quant):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    mod = ku_quant.QuantDense(24, act_quant=act_quant)
    qp = ku_quant.quantize_weights({"kernel": w, "bias": b},
                                   mod.init(jax.random.key(0), x)["params"])
    want = jax.jit(mod.apply)({"params": qp}, x)
    port = QuantDense(16, 24, act_quant=act_quant, device="cpu")
    port.load_state_dict(quantize_weights({"kernel": torch.from_numpy(w),
                                           "bias": torch.from_numpy(b)}, port))
    _close(port(torch.from_numpy(x)), want)
    np.testing.assert_array_equal(port.kernel.numpy(), np.asarray(qp["kernel"]))


def test_int8_act_matmul_matches_ku():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    wq = rng.integers(-127, 128, size=(16, 24)).astype(np.int8)
    sc = rng.uniform(0.01, 0.05, size=(24,)).astype(np.float32)
    want = jax.jit(ku_quant.int8_act_matmul)(x, wq, sc)
    calls = int8_act_matmul.int_mm_calls
    got = int8_act_matmul(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(sc))
    assert int8_act_matmul.int_mm_calls == calls + 1  # one int8 product
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("quant", [True, "w8a8"])
def test_quant_transformer_forward_matches_ku(block_pair, quant):
    x = block_pair["x"]
    model = ku.Transformer(quant_weights=quant, **block_pair["kw"])
    want = jax.jit(model.apply)({"params": block_pair["qparams"]}, [x])
    with torch.no_grad():
        got = _port_quant(block_pair, quant)([torch.from_numpy(x)])
    _close(got, want)


@pytest.mark.parametrize("quant,cache_kw", [
    (True, {}), (True, dict(kv_cache_dtype="int8")), (True, dict(kv_page_size=4)),
    ("w8a8", {}),
])
def test_quant_decode_matches_ku(block_pair, quant, cache_kw):
    """A prefill of 5 tokens, then one token a step, dense, int8 and paged
    caches: every output against ku's."""
    x = block_pair["x"]
    model = ku.Transformer(quant_weights=quant, **block_pair["kw"], **cache_kw)
    qparams = block_pair["qparams"]
    call = jax.jit(lambda c, t: model.apply({"params": qparams, **c}, [t], decode=True,
                                            mutable=["cache"]))
    port = _port_quant(block_pair, quant, **cache_kw)
    cache, cache_t = {}, {}
    with torch.no_grad():
        for lo, hi in [(0, 5)] + [(i, i + 1) for i in range(5, T)]:
            want, cache = call(cache, x[:, lo:hi])
            got, cache_t = port([torch.from_numpy(x[:, lo:hi])], decode=True, cache=cache_t)
            _close(got, want, f"call at {lo}")


def test_quantize_weights_validates():
    port = QuantDense(16, 8, device="cpu")
    with pytest.raises(ValueError, match="params missing weight kernel"):
        quantize_weights({"bias": torch.zeros(8)}, port)
    with pytest.raises(ValueError, match=r"kernel: shape \(4, 8\) != template \(16, 8\)"):
        quantize_weights({"kernel": torch.zeros(4, 8), "bias": torch.zeros(8)}, port)
    with pytest.raises(ValueError, match="params missing module Dense_0"):
        quantize_weights({"Dense_1.kernel": torch.zeros(4, 4)},
                         {"Dense_0.kernel": torch.zeros(4, 4, dtype=torch.int8)})
    with pytest.raises(ValueError, match="quant_weights"):
        Transformer(2, 8, quant_weights="int4", device="cpu")
    # ku's messages, for the same mistakes.
    tpl = ku_quant.QuantDense(8).init(jax.random.key(0), jnp.zeros((2, 16)))["params"]
    with pytest.raises(ValueError, match="params missing weight kernel"):
        ku_quant.quantize_weights({"bias": jnp.zeros((8,))}, tpl)
    with pytest.raises(ValueError, match=r"kernel: shape \(4, 8\) != template \(16, 8\)"):
        ku_quant.quantize_weights({"kernel": jnp.zeros((4, 8)), "bias": jnp.zeros((8,))}, tpl)
