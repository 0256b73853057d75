"""The plain version of ku_torch's flash-attention backward against ku's
Pallas backward in interpret mode, on the CPU, and the autograd function
that joins forward and backward.

Both backwards get the same o and lse, from ku's Pallas forward in interpret
mode, so that differences of the forwards do not enter; inputs and dO come
from a numpy seed. Every query row has at least one live key: ku spreads a
dead row's gradient over its masked keys (lse = -1e30 there, so exp(s - lse)
is 1), where the port gives such a row no gradient (ROADMAP §3). Tolerances:
f32 rtol/atol 1e-5 (ku streams key and query blocks, the plain version
takes the whole score matrix at once). bf16: rtol 2e-2 and atol 1e-2 of the
largest entry of each gradient: p and ds are rounded to bf16 before their
products, and a difference of an ulp in the f32 score moves a few of those
roundings (2^-8 of the value each); ku also rounds each query head's dk/dv
partial to bf16 before summing a GQA group, where the port rounds the
group's sum once (measured: dk/dv differ by up to 0.5 % of their largest
entry, dq by less than 1e-4 of it). The kernels themselves are held
against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ku.pallas.flash_attention import _bwd_pallas, _fwd_pallas
from ku_torch.kernels import flash_attention as fa

TOL = dict(rtol=1e-5, atol=1e-5)
SCALE = 0.35

CASES = {
    # GQA 4/2, causal, N = KN = 44: neither a multiple of 16.
    "gqa_causal_ragged": dict(b=2, h=4, hkv=2, n=44, kn=44, d=16),
    # Bidirectional MQA (4 over 1), a short query block over 44 keys.
    "mqa_bidirectional": dict(b=1, h=4, hkv=1, n=37, kn=44, d=8, causal=False),
    # A causal window.
    "window": dict(b=2, h=4, hkv=2, n=44, kn=44, d=16, window=7),
    # Packed segments, causal.
    "segments": dict(b=2, h=2, hkv=2, n=45, kn=45, d=8, segments=True),
    # A softcap over GQA 4/1.
    "softcap": dict(b=2, h=4, hkv=1, n=30, kn=30, d=16, softcap=1.5),
    # Scalar offsets on both sides (ku's backward takes scalars only).
    "scalar_offsets": dict(b=2, h=4, hkv=2, n=40, kn=44, d=16, q_offset=3,
                           k_offset=1),
    # bf16: GQA with a softcap, and a window over segments.
    "bf16_gqa_softcap": dict(b=2, h=4, hkv=2, n=44, kn=44, d=16, softcap=2.0,
                             bf16=True),
    "bf16_window_segments": dict(b=2, h=4, hkv=1, n=45, kn=45, d=16, window=9,
                                 segments=True, bf16=True),
    # Key and value heads of widths the tensor-core tiles zero-fill.
    "d40_dv24": dict(b=1, h=2, hkv=1, n=33, kn=45, d=40, dv=24),
}


def _torch(a):
    """numpy (float32, int32 or ml_dtypes.bfloat16) → a CPU tensor."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _inputs(rng, c):
    dt = ml_dtypes.bfloat16 if c.get("bf16") else np.float32
    q = rng.normal(size=(c["b"], c["h"], c["n"], c["d"])).astype(dt)
    dv = c.get("dv", c["d"])
    k, v = (rng.normal(size=(c["b"], c["hkv"], c["kn"], w)).astype(dt) for w in (c["d"], dv))
    do = rng.normal(size=(c["b"], c["h"], c["n"], dv)).astype(dt)
    seg = None
    if c.get("segments"):
        seg = np.sort(rng.integers(0, 4, size=(c["b"], c["n"])), axis=1
                      ).astype(np.int32)
    return q, k, v, do, seg


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_ku_interpret(rng, name):
    c = CASES[name]
    causal, window, softcap = c.get("causal", True), c.get("window"), c.get("softcap")
    q_off, k_off = c.get("q_offset"), c.get("k_offset")
    q, k, v, do, seg = _inputs(rng, c)
    seg_j = None if seg is None else jnp.asarray(seg)
    fwd = jax.jit(functools.partial(
        _fwd_pallas, softmax_scale=SCALE, block_q=None, block_k=None,
        causal=causal, interpret=True, window=window, q_offset=q_off,
        k_offset=k_off, softcap=softcap))
    bwd = jax.jit(lambda q, k, v, o, lse, do, seg: _bwd_pallas(
        q, k, v, o, lse, do, SCALE, None, None, causal, True, softcap=softcap,
        q_offset=q_off, k_offset=k_off, window=window, segment_ids=seg))
    o, lse = fwd(q, k, v, segment_ids=seg_j)
    want = bwd(*(jnp.asarray(a) for a in (q, k, v)), o, lse, jnp.asarray(do), seg_j)

    before = (fa.flash_bwd_dq_cuda.launches, fa.flash_bwd_dkv_cuda.launches)
    got = fa.flash_bwd(*(_torch(a) for a in (q, k, v, o, lse, do)),
                       softmax_scale=SCALE, causal=causal, window=window,
                       segment_ids=None if seg is None else _torch(seg),
                       q_offset=q_off, k_offset=k_off, logit_softcap=softcap)
    assert (fa.flash_bwd_dq_cuda.launches, fa.flash_bwd_dkv_cuda.launches) == before
    for what, g, w, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == _torch(t).dtype and g.shape == t.shape, what
        w = np.asarray(w).astype(np.float32)
        g = g.float().numpy()
        if c.get("bf16"):
            np.testing.assert_allclose(g, w, rtol=2e-2, atol=1e-2 * np.abs(w).max(),
                                       err_msg=what)
        else:
            np.testing.assert_allclose(g, w, **TOL, err_msg=what)


def _f64(rng, *shapes):
    return [torch.from_numpy(rng.normal(size=s)).requires_grad_() for s in shapes]


GRAD_KW = {
    "causal_gqa_softcap": dict(causal=True, logit_softcap=1.5),
    "window_segments_rowoffsets": dict(
        causal=True, window=3, segment_ids=torch.tensor([[0, 0, 0, 1, 1, 1, 1],
                                                         [0, 0, 1, 1, 1, 2, 2]]),
        q_offset=torch.tensor([2, 0]), k_offset=1),
    "bidirectional": dict(causal=False),
}


@pytest.mark.parametrize("name", sorted(GRAD_KW))
def test_autograd_function_gradcheck(rng, name):
    """float64, tiny shapes: the backward against finite differences, and
    against autograd through the plain forward."""
    kw = dict(GRAD_KW[name], softmax_scale=0.7)
    q, k, v = _f64(rng, (2, 4, 7, 6), (2, 2, 8, 6), (2, 2, 8, 5))
    if "segment_ids" in kw:  # one (B, N) array for both sides: KN = N
        k, v = (t.detach()[:, :, :7].requires_grad_() for t in (k, v))
    fn = functools.partial(fa.flash_attention, **kw)
    assert torch.autograd.gradcheck(fn, (q, k, v))
    do = torch.from_numpy(rng.normal(size=(2, 4, 7, 5)))
    got = torch.autograd.grad(fn(q, k, v), (q, k, v), do)
    want = torch.autograd.grad(fa.flash_fwd_torch(q, k, v, **kw)[0], (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)


def test_rows_with_no_live_key_get_no_gradient(rng):
    """Keys start at global position 10: causal query rows 0..9 of batch row
    0 see none, and batch row 1 (queries at -80..-11) sees none at all.
    Such rows get dq = 0 and add nothing to dk or dv: the gradients equal
    those with their dO set to 0."""
    q = torch.from_numpy(rng.normal(size=(2, 2, 20, 8))).float().requires_grad_()
    k, v = (torch.from_numpy(rng.normal(size=(2, 1, 20, 8))).float().requires_grad_()
            for _ in range(2))
    kw = dict(causal=True, k_offset=10, q_offset=torch.tensor([0, -80]),
              softmax_scale=0.3)
    do = torch.from_numpy(rng.normal(size=(2, 2, 20, 8))).float()
    dq, dk, dv = torch.autograd.grad(fa.flash_attention(q, k, v, **kw), (q, k, v), do)
    assert torch.all(dq[0, :, :10] == 0) and torch.all(dq[1] == 0)
    assert torch.all(dk[1] == 0) and torch.all(dv[1] == 0)
    # (Row 10 sees one key, whose softmax has no gradient in the score.)
    assert torch.all(dq[0, :, 11:].abs().sum(-1) > 1e-3)
    live_do = do.clone()
    live_do[0, :, :10] = 0
    live_do[1] = 0
    again = torch.autograd.grad(fa.flash_attention(q, k, v, **kw), (q, k, v), live_do)
    for g, w in zip((dq, dk, dv), again):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_backward_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 2, 3, 8)
    lse = torch.zeros(1, 2, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_bwd_dq_cuda(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_bwd_dkv_cuda(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_bwd(q, q[:, :1].repeat(1, 3, 1, 1), q[:, :1].repeat(1, 3, 1, 1),
                     q, lse, q)
    with pytest.raises(ValueError, match="window requires"):
        fa.flash_bwd(q, q, q, q, lse, q, window=2)
