"""The plain version of ku_torch's flash-attention forward against ku's
Pallas forward in interpret mode, on the CPU: output and f32 LSE.

Same numpy-made inputs on both sides; f32 rtol/atol 1e-5 (ku streams the
keys block by block, the plain version takes the whole score matrix at
once). Shapes are ragged (N and KN not multiples of any block) and no query
row is fully masked. The kernel itself is held against the plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ku.pallas.flash_attention import _fwd_pallas
from ku_torch.kernels import flash_attention as fa

TOL = dict(rtol=1e-5, atol=1e-5)

CASES = {
    # GQA 4/2, causal + window + softcap, per-row query offsets into a
    # longer key axis (a chunked prefill against a cache page).
    "gqa_window_softcap_rowoffsets": dict(
        b=2, h=4, hkv=2, n=37, kn=53, d=16, causal=True, window=7,
        softcap=1.5, q_offset=[16, 3], k_offset=None, segments=False),
    # Packed segments, causal, scalar offsets on both sides.
    "segments_scalar_offsets": dict(
        b=2, h=2, hkv=2, n=45, kn=45, d=8, causal=True, window=None,
        softcap=None, q_offset=3, k_offset=1, segments=True),
    # Bidirectional MQA, a short query block over many keys.
    "mqa_noncausal": dict(
        b=1, h=3, hkv=1, n=5, kn=70, d=8, causal=False, window=None,
        softcap=None, q_offset=None, k_offset=None, segments=False),
    # Key and value heads of widths the tensor-core tiles zero-fill.
    "d40_dv24": dict(
        b=1, h=2, hkv=1, n=33, kn=45, d=40, dv=24, causal=True, window=None,
        softcap=None, q_offset=None, k_offset=None, segments=False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_forward_matches_ku_interpret(rng, name):
    c = CASES[name]
    q = rng.normal(size=(c["b"], c["h"], c["n"], c["d"])).astype(np.float32)
    k = rng.normal(size=(c["b"], c["hkv"], c["kn"], c["d"])).astype(np.float32)
    v = rng.normal(size=(c["b"], c["hkv"], c["kn"], c.get("dv", c["d"]))).astype(np.float32)
    seg = None
    if c["segments"]:
        seg = np.sort(rng.integers(0, 4, size=(c["b"], c["n"])), axis=1
                      ).astype(np.int32)
    offsets = {}
    for key in ("q_offset", "k_offset"):
        if c[key] is not None:
            offsets[key] = np.asarray(c[key], np.int32)
    want_o, want_lse = _fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.35, None, None,
        c["causal"], True, window=c["window"],
        segment_ids=None if seg is None else jnp.asarray(seg),
        softcap=c["softcap"],
        **{key: jnp.asarray(val) for key, val in offsets.items()})
    before = fa.flash_fwd_cuda.launches
    got_o, got_lse = fa.flash_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        softmax_scale=0.35, causal=c["causal"], window=c["window"],
        segment_ids=None if seg is None else torch.from_numpy(seg),
        logit_softcap=c["softcap"],
        **{key: torch.from_numpy(val) for key, val in offsets.items()})
    assert fa.flash_fwd_cuda.launches == before  # CPU: plain version
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


def test_rows_with_no_live_key_are_zero(rng):
    # Keys start at global position 10: causal rows 0..9 of row 0 see none,
    # and row 1 (queries at -80..-11) sees none at all.
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 70, 8)).astype(np.float32))
               for _ in range(3))
    o, lse = fa.flash_fwd(q, k[:, :1], v[:, :1], causal=True, k_offset=10,
                          q_offset=torch.tensor([0, -80], dtype=torch.int32))
    assert torch.all(o[0, :, :10] == 0) and torch.all(o[1] == 0)
    assert torch.all(lse[0, :, :10] == -1e30) and torch.all(lse[1] == -1e30)
    assert torch.all(o[0, :, 10:].abs().sum(-1) > 0)
    assert torch.isfinite(lse[0, :, 10:]).all() and (lse[0, :, 10:] > -1e3).all()


def test_wrapper_refuses_what_the_kernel_does_not_take(rng):
    q = torch.zeros(1, 4, 3, 8)
    k = torch.zeros(1, 3, 5, 8)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_fwd(q, k, k)
    with pytest.raises(ValueError, match="window requires"):
        fa.flash_fwd(q, q, q, window=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_fwd_cuda(q, q, q)
    with pytest.raises(ValueError, match="segment_ids"):
        fa.flash_fwd(q, q, q, segment_ids=torch.zeros(1, 2, dtype=torch.int32))


def test_flash_attention_refuses_gradients(rng):
    """Named for what it checked before the backward was ported: now that
    flash_attention is differentiable on the CPU (through the backward's
    plain version, the kernels not launched), and forward-only under
    torch.no_grad()."""
    q = torch.from_numpy(rng.normal(size=(1, 2, 3, 8)).astype(np.float32))
    q.requires_grad_()
    before = (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
              fa.flash_bwd_dkv_cuda.launches)
    out = fa.flash_attention(q, q, q, causal=True)
    assert out.grad_fn is not None and out.shape == (1, 2, 3, 8)
    (grad,) = torch.autograd.grad(out.sum(), q)
    assert torch.isfinite(grad).all() and grad.abs().sum() > 0
    assert (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
            fa.flash_bwd_dkv_cuda.launches) == before
    with torch.no_grad():
        plain = fa.flash_attention(q, q, q, causal=True)
    assert plain.grad_fn is None
    torch.testing.assert_close(plain, out.detach(), rtol=0, atol=0)
