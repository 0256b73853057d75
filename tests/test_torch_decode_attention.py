"""The plain version of ku_torch's flash-decoding kernel against ku's Pallas
kernel in interpret mode, on the CPU.

Same numpy-made inputs on both sides; f32 rtol/atol 1e-5 (ku folds the
slots block by block, the plain version all at once: the sums are taken in
another order). The kernel itself is held against the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ku.pallas.decode_attention import decode_attention as ku_decode
from ku_torch.kernels import decode_attention as da

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(rng, b, hkv, g, d, s, quant):
    q = rng.normal(size=(b, hkv, g, d)).astype(np.float32)
    if quant:
        k = rng.integers(-127, 128, size=(b, hkv, d, s)).astype(np.int8)
        v = rng.integers(-127, 128, size=(b, hkv, d, s)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, size=(b, hkv, s)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, size=(b, hkv, s)).astype(np.float32)
        return q, k, v, ks, vs
    k = rng.normal(size=(b, hkv, d, s)).astype(np.float32)
    v = rng.normal(size=(b, hkv, d, s)).astype(np.float32)
    return q, k, v, None, None


@pytest.mark.parametrize("case", [
    # G 4, softcap, 16-slot blocks over 48 slots, a row of 1 and a full row.
    # (S is a multiple of ku's block: its interpret mode reads NaN past S.)
    dict(b=2, hkv=2, g=4, d=16, s=48, lengths=[1, 48], softcap=2.5,
         block_t=16, quant=False),
    # G 1 (MHA), int8 cache with per-slot scales, ragged lengths.
    dict(b=3, hkv=2, g=1, d=8, s=32, lengths=[7, 32, 20], softcap=None,
         block_t=16, quant=True),
])
def test_plain_decode_matches_ku_interpret(rng, case):
    q, k, v, ks, vs = _inputs(rng, case["b"], case["hkv"], case["g"],
                              case["d"], case["s"], case["quant"])
    lengths = np.asarray(case["lengths"], np.int32)
    scale = 0.3
    want = ku_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(lengths),
                     k_scale=None if ks is None else jnp.asarray(ks),
                     v_scale=None if vs is None else jnp.asarray(vs),
                     softmax_scale=scale, logit_softcap=case["softcap"],
                     block_t=case["block_t"], interpret=True)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    before = da.decode_attention_cuda.launches
    got = da.decode_attention(t(q), t(k), t(v), t(lengths), k_scale=t(ks),
                              v_scale=t(vs), softmax_scale=scale,
                              logit_softcap=case["softcap"])
    assert da.decode_attention_cuda.launches == before  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_default_scale_is_one_over_sqrt_head_dim(rng):
    q, k, v, _, _ = _inputs(rng, 1, 1, 2, 16, 9, False)
    lengths = torch.tensor([9], dtype=torch.int32)
    t = torch.from_numpy
    torch.testing.assert_close(
        da.decode_attention(t(q), t(k), t(v), lengths),
        da.decode_attention(t(q), t(k), t(v), lengths, softmax_scale=0.25))


def test_rows_of_length_zero_are_zero(rng):
    q, k, v, _, _ = _inputs(rng, 3, 2, 4, 8, 6, False)
    t = torch.from_numpy
    out = da.decode_attention(t(q), t(k), t(v),
                              torch.tensor([0, 3, -1], dtype=torch.int32))
    assert torch.all(out[0] == 0) and torch.all(out[2] == 0)
    assert torch.all(out[1].abs().sum(-1) > 0)


def test_wrapper_refuses_what_the_kernel_does_not_take(rng):
    q, k, v, ks, vs = _inputs(rng, 2, 1, 2, 8, 5, True)
    t = torch.from_numpy
    lengths = torch.tensor([5, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        da.decode_attention_cuda(t(q), t(k), t(v), lengths, k_scale=t(ks),
                                 v_scale=t(vs))
    with pytest.raises(ValueError, match="int8 caches"):
        da.decode_attention(t(q), t(k), t(v), lengths)
    with pytest.raises(ValueError, match="lengths"):
        da.decode_attention(t(q), t(k), t(v), lengths[:1], k_scale=t(ks),
                            v_scale=t(vs))
