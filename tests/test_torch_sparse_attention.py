"""ku_torch's block-sparse attention against ku's, on the CPU: the block
maps, the plain forward and backward against ku's Pallas kernels in
interpret mode, and the autograd function that joins them.

The maps must equal ku's bit for bit. The backwards get the same o and lse,
from ku's forward, so that differences of the forwards do not enter; inputs
and dO come from a numpy seed. Tolerances: f32 rtol/atol 1e-5 (ku streams
one map block at a time, the plain versions take a query block's or a key
block's whole run at once, so sums run in other orders). ku's side stays
under jit and at a few heads (its interpret mode costs a few ms a grid
step). A query row with no live key is where the port differs from ku
(ROADMAP §3): ku gives it the mean of the masked values, the port o = 0,
lse = -1e30 and no gradient; those rows are pinned apart. The kernels
themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ku.pallas import sparse_attention as ku_sparse
from ku_torch.kernels import sparse_attention as sa

TOL = dict(rtol=1e-5, atol=1e-5)
SCALE = 0.3


def _pattern():
    """tests/test_sparse_attention.py's strided block pattern: the diagonal,
    two blocks back and the first block, over 6 blocks."""
    pat = np.zeros((6, 6), bool)
    for i in range(6):
        pat[i, i] = pat[i, max(0, i - 2)] = pat[i, 0] = True
    return pat


def _cross():
    """Cross-attention over 2 x 6 blocks; key blocks 3, 4 and 5 unattended."""
    pat = np.zeros((2, 6), bool)
    pat[0, 0] = pat[0, 2] = pat[1, 1] = True
    return pat


MASKS = {
    "structure": ((128,), dict(block_q=16, block_k=16, causal=True, window=24,
                               global_prefix=4)),
    "causal": ((96,), dict(block_q=16, block_k=16, causal=True)),
    "window": ((96,), dict(block_q=16, block_k=16, causal=True, window=20)),
    "window_sinks": ((96,), dict(block_q=16, block_k=16, causal=True, window=20,
                                 global_prefix=5)),
    "window_sinks_extra": ((96,), dict(block_q=16, block_k=16, causal=True,
                                       window=20, global_prefix=5,
                                       extra_blocks=((5, 1), (4, 0)))),
    "bidirectional": ((64,), dict(block_q=16, block_k=32)),
    "causal_pattern": ((96,), dict(block_q=16, block_k=16, causal=True,
                                   block_pattern=_pattern())),
    "cross_unattended": ((32, 96), dict(block_q=16, block_k=16,
                                        block_pattern=_cross())),
    "nonsquare_blocks": ((96,), dict(block_q=32, block_k=16, causal=True,
                                     window=20, global_prefix=5)),
    "short_keys_window": ((64, 32), dict(block_q=16, block_k=16, causal=True,
                                         window=24)),
    "lm_training": ((8192,), dict(block_q=512, block_k=512, causal=True,
                                  window=2048, global_prefix=128)),
    "sparse_gate_64k": ((65536,), dict(causal=True, window=4096, global_prefix=128)),
    "blocks_128x64": ((256,), dict(block_q=128, block_k=64, causal=True, window=100,
                                   global_prefix=10)),
}


@pytest.mark.parametrize("name", sorted(MASKS))
def test_block_mask_matches_ku_bit_for_bit(name):
    args, kw = MASKS[name]
    want = ku_sparse.make_block_mask(*args, **kw)
    got = sa.make_block_mask(*args, **kw)
    for field in ("fmap", "tmap", "kcnt", "qcnt"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    for field in ("n", "kn", "block_q", "block_k", "causal", "window",
                  "global_prefix", "meta", "sparsity"):
        assert getattr(got, field) == getattr(want, field), field
    fmap, tmap, fptr, tptr = got.arrays("cpu")
    assert got.arrays("cpu")[0] is fmap  # made once per device, then kept
    assert torch.equal(fmap, torch.from_numpy(want.fmap))
    assert torch.equal(tmap, torch.from_numpy(want.tmap))
    # Each run starts where its first-of-run flag says.
    assert torch.equal(fmap[fptr[:-1], ku_sparse._FIRST], torch.ones(len(fptr) - 1,
                                                                  dtype=torch.int32))
    live = tptr[1:] > tptr[:-1]
    assert torch.equal(tmap[tptr[:-1][live], ku_sparse._FIRST],
                       torch.ones(int(live.sum()), dtype=torch.int32))
    assert int(fptr[-1]) == int(tptr[-1]) == want.fmap.shape[0]


def test_block_mask_sizes_of_the_lm_and_the_gate():
    lm = sa.make_block_mask(8192, block_q=512, block_k=512, causal=True,
                            window=2048, global_prefix=128)
    gate = sa.make_block_mask(65536, causal=True, window=4096, global_prefix=128)
    assert lm.fmap.shape[0] == 81 and lm.sparsity == 1 - 81 / 256
    assert gate.fmap.shape[0] == 1235
    assert sa.kept_pairs(lm) == 15_459_392


def _dense_keep(n, kn, bq, bk, causal, window, global_prefix, extra_blocks=(),
                block_pattern=None):
    """tests/test_sparse_attention.py's element-level keep matrix."""
    q_pos, k_pos = np.arange(n)[:, None], np.arange(kn)[None, :]
    keep = np.ones((n, kn), bool)
    if causal:
        keep &= k_pos <= q_pos
    if block_pattern is not None:
        keep &= np.repeat(np.repeat(block_pattern, bq, 0), bk, 1)
    elif window is not None:
        w = (q_pos - k_pos < window) | (k_pos < global_prefix)
        for qb, kb in extra_blocks:
            w[qb * bq:(qb + 1) * bq, kb * bk:(kb + 1) * bk] = True
        keep &= w
    return keep


@pytest.mark.parametrize("name", ["structure", "window_sinks_extra", "causal_pattern",
                                  "cross_unattended", "nonsquare_blocks"])
def test_kept_pairs_is_the_element_mask_count(name):
    args, kw = MASKS[name]
    mask = sa.make_block_mask(*args, **kw)
    keep = _dense_keep(mask.n, mask.kn, mask.block_q, mask.block_k, mask.causal,
                       mask.window, mask.global_prefix, kw.get("extra_blocks", ()),
                       kw.get("block_pattern"))
    assert sa.kept_pairs(mask) == int(keep.sum())


BAD_MASKS = {
    "divide": ((100,), dict(block_q=16, block_k=16)),
    "window_requires_causal": ((64,), dict(block_q=16, block_k=16, window=8)),
    "escapes": ((64,), dict(block_q=16, block_k=16, causal=True, global_prefix=4)),
    "extra_escapes": ((64,), dict(block_q=16, block_k=16, causal=True,
                                  extra_blocks=((1, 0),))),
    "exclusive": ((64,), dict(block_q=16, block_k=16, causal=True, window=8,
                              block_pattern=np.ones((4, 4), bool))),
    "pattern_shape": ((64,), dict(block_q=16, block_k=16, block_pattern=np.ones((4, 3), bool))),
    "attend_no": ((32, 96), dict(block_q=16, block_k=16,
                                 block_pattern=np.zeros((2, 6), bool))),
    "window_misses_keys": ((64, 32), dict(block_q=16, block_k=16, causal=True, window=8)),
}


@pytest.mark.parametrize("name", sorted(BAD_MASKS))
def test_block_mask_rejects_what_ku_rejects(name):
    args, kw = BAD_MASKS[name]
    with pytest.raises(ValueError) as want:
        ku_sparse.make_block_mask(*args, **kw)
    with pytest.raises(ValueError) as got:
        sa.make_block_mask(*args, **kw)
    assert str(got.value) == str(want.value)


# (mask, B, H, Hkv, D, Dv): ku's pattern primitives (tests/test_sparse_attention
# .py:88-94), a causal block pattern, the unattended cross pattern, GQA with
# Dv != D, and non-square blocks.
CASES = {
    "causal": ("causal", 1, 2, 2, 16, 16),
    "window": ("window", 1, 2, 2, 16, 16),
    "window_sinks": ("window_sinks", 1, 2, 2, 16, 16),
    "window_sinks_extra": ("window_sinks_extra", 1, 2, 2, 16, 16),
    "causal_pattern": ("causal_pattern", 1, 2, 2, 16, 16),
    "cross_unattended": ("cross_unattended", 1, 2, 2, 16, 16),
    "gqa_narrow_values": ("window_sinks", 1, 4, 2, 16, 8),
    "nonsquare_blocks_mqa": ("nonsquare_blocks", 1, 2, 1, 8, 12),
    # The card's tensor-core kernels pad widths to 16 (D 40, Dv 24) and
    # take map blocks of 16 and of 128 x 64 in 64-row sub-tiles.
    "d40_dv24_blocks_16": ("window_sinks", 1, 2, 1, 40, 24),
    "d40_dv24_blocks_128x64": ("blocks_128x64", 1, 2, 1, 40, 24),
}


def _inputs(rng, mask, b, h, hkv, d, dv):
    q = rng.normal(size=(b, h, mask.n, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, mask.kn, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, mask.kn, dv)).astype(np.float32)
    do = rng.normal(size=(b, h, mask.n, dv)).astype(np.float32)
    return q, k, v, do


def _ku(mask, q, k, v, do):
    """ku's interpret-mode forward, then its backward on that o and lse."""
    fmap, tmap = mask.arrays()
    zero_fill = tuple(int(i) for i in np.nonzero(mask.qcnt == 0)[0])
    meta = (mask.block_q, mask.block_k, mask.meta)
    fwd = jax.jit(functools.partial(ku_sparse._sparse_fwd, softmax_scale=SCALE,
                                    block_q=meta[0], block_k=meta[1], meta=meta[2],
                                    interpret=True))
    o, lse = fwd(*(jnp.asarray(a) for a in (q, k, v)), fmap)
    grads = ku_sparse._sparse_bwd(*(jnp.asarray(a) for a in (q, k, v)), o, lse,
                                  jnp.asarray(do), fmap, tmap, SCALE, *meta, True,
                                  zero_fill)
    return [np.asarray(x) for x in (o, lse, *grads)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_versions_match_ku_interpret(rng, name):
    mask_name, b, h, hkv, d, dv = CASES[name]
    args, kw = MASKS[mask_name]
    mask = sa.make_block_mask(*args, **kw)
    q, k, v, do = _inputs(rng, mask, b, h, hkv, d, dv)
    o_w, lse_w, *want = _ku(ku_sparse.make_block_mask(*args, **kw), q, k, v, do)

    launches = (sa.sparse_fwd_cuda.launches, sa.sparse_bwd_dq_cuda.launches,
                sa.sparse_bwd_dkv_cuda.launches)
    o, lse = sa.sparse_fwd(_t(q), _t(k), _t(v), mask, SCALE)
    np.testing.assert_allclose(o.numpy(), o_w, **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_w, **TOL)
    got = sa.sparse_bwd(*(_t(a) for a in (q, k, v, o_w, lse_w, do)), mask, SCALE)
    assert launches == (sa.sparse_fwd_cuda.launches, sa.sparse_bwd_dq_cuda.launches,
                        sa.sparse_bwd_dkv_cuda.launches)
    for what, g, w, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == torch.float32, what
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=what)
    if name == "cross_unattended":  # key blocks 3..5: exactly zero
        assert torch.all(got[1][:, :, 48:] == 0) and torch.all(got[2][:, :, 48:] == 0)


@pytest.mark.parametrize("name", ["short_keys_window", "pattern_after_row"])
def test_rows_with_no_live_key(rng, name):
    """A window over a shorter key axis (queries 55..63 see none of the 32
    keys), or a causal block pattern whose only live block for query block 0
    starts after its rows 0..15. The port writes o = 0 and lse = -1e30 there
    and gives them no gradient; ku returns the mean of the masked values.
    Every other row, and every gradient once the dead rows' dO is 0 (then
    ku's dead rows add nothing either), agrees with ku."""
    if name == "short_keys_window":
        args, kw = MASKS[name]
    else:
        pat = np.array([[0, 1, 0, 0], [0, 0, 1, 1]], bool)
        args, kw = (64,), dict(block_q=32, block_k=16, causal=True, block_pattern=pat)
    mask = sa.make_block_mask(*args, **kw)
    keep = _dense_keep(mask.n, mask.kn, mask.block_q, mask.block_k, mask.causal,
                       mask.window, mask.global_prefix, (), kw.get("block_pattern"))
    dead = ~keep.any(axis=1)
    assert dead.sum() == (9 if name == "short_keys_window" else 16)
    q, k, v, do = _inputs(rng, mask, 1, 2, 1, 8, 8)
    do[:, :, dead] = 0
    o_w, lse_w, *want = _ku(ku_sparse.make_block_mask(*args, **kw), q, k, v, do)

    o, lse = sa.sparse_fwd(_t(q), _t(k), _t(v), mask, SCALE)
    assert torch.all(o[:, :, dead] == 0) and torch.all(lse[:, :, dead] == -1e30)
    assert np.abs(o_w[:, :, dead]).max() > 0.1  # ku: the mean of the masked values
    np.testing.assert_allclose(o.numpy()[:, :, ~dead], o_w[:, :, ~dead], **TOL)
    np.testing.assert_allclose(lse.numpy()[:, :, ~dead], lse_w[:, :, ~dead], **TOL)

    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    full_do = _t(do)
    full_do[:, :, dead] = _t(rng.normal(size=(1, 2, int(dead.sum()), 8)).astype(np.float32))
    got = torch.autograd.grad(sa.sparse_attention(qt, kt, vt, mask, SCALE), (qt, kt, vt),
                              full_do)
    assert torch.all(got[0][:, :, dead] == 0)
    for what, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=what)


def _f64(rng, *shapes):
    return [torch.from_numpy(rng.normal(size=s)).requires_grad_() for s in shapes]


GRAD_MASKS = {
    "window_sinks_gqa": ((12,), dict(block_q=4, block_k=4, causal=True, window=5,
                                     global_prefix=2), 12),
    "extra_blocks_nonsquare": ((12,), dict(block_q=6, block_k=3, causal=True, window=3,
                                           extra_blocks=((1, 0),)), 12),
    "cross_unattended": ((4, 12), dict(block_q=2, block_k=2, block_pattern=np.array(
        [[1, 0, 1, 0, 0, 0], [0, 1, 0, 0, 0, 0]], bool)), 12),
}


@pytest.mark.parametrize("name", sorted(GRAD_MASKS))
def test_autograd_function_gradcheck(rng, name):
    """float64, tiny shapes: SparseAttention's backward against finite
    differences, and against autograd through the plain forward."""
    args, kw, kn = GRAD_MASKS[name]
    mask = sa.make_block_mask(*args, **kw)
    q, k, v = _f64(rng, (1, 4, mask.n, 4), (1, 2, kn, 4), (1, 2, kn, 3))
    fn = functools.partial(sa.sparse_attention, mask=mask, softmax_scale=0.7)
    assert torch.autograd.gradcheck(fn, (q, k, v))
    do = torch.from_numpy(rng.normal(size=(1, 4, mask.n, 3)))
    got = torch.autograd.grad(fn(q, k, v), (q, k, v), do)
    want = torch.autograd.grad(sa.sparse_fwd_torch(q, k, v, mask, 0.7)[0], (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)


def test_no_grad_takes_the_forward_alone(rng, monkeypatch):
    mask = sa.make_block_mask(32, block_q=16, block_k=16, causal=True)
    q, k, v = (torch.randn(1, 2, 32, 8, requires_grad=True) for _ in range(3))
    monkeypatch.setattr(sa.SparseAttention, "apply", None)
    with torch.no_grad():
        o = sa.sparse_attention(q, k, v, mask)
    torch.testing.assert_close(o, sa.sparse_fwd_torch(q, k, v, mask)[0])


def test_wrappers_refuse_what_the_kernels_do_not_take():
    mask = sa.make_block_mask(32, block_q=16, block_k=16, causal=True)
    q = torch.zeros(1, 2, 32, 8)
    lse = torch.zeros(1, 2, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sa.sparse_fwd_cuda(q, q, q, mask)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sa.sparse_bwd_dq_cuda(q, q, q, q, lse, lse, mask)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sa.sparse_bwd_dkv_cuda(q, q, q, q, lse, lse, mask)
    wide = torch.zeros(1, 2, 32, 160)
    with pytest.raises(ValueError, match="up to 128"):
        sa.sparse_fwd_cuda(wide, wide, wide, mask)
    with pytest.raises(ValueError, match="do not match the BlockMask"):
        sa.sparse_fwd(q[:, :, :16], q, q, mask)
    with pytest.raises(ValueError, match="multiple"):
        sa.sparse_bwd(q, q[:, :1].repeat(1, 3, 1, 1), q[:, :1].repeat(1, 3, 1, 1), q, lse,
                      q, mask)


def _refused(name):
    """(wrapper call, message) for each thing the wrappers refuse, on CPU
    tensors: every shape check comes before the device check, so each is
    refused here as on the card."""
    mask = sa.make_block_mask(32, block_q=16, block_k=16, causal=True)
    q = torch.zeros(1, 4, 32, 8)
    kv = torch.zeros(1, 2, 32, 8)
    lse = torch.zeros(1, 4, 32)
    bwd = functools.partial(sa.sparse_bwd_dq_cuda, mask=mask)
    return {
        "not_4d": (lambda: sa.sparse_fwd_cuda(q[0], kv, kv, mask), r"\(B, H, N, D\)"),
        "heads_not_a_multiple": (lambda: sa.sparse_fwd_cuda(q[:, :3], kv, kv, mask),
                                 "multiple"),
        "widths_do_not_fit": (lambda: sa.sparse_fwd_cuda(q, kv[..., :4], kv, mask),
                              "do not fit"),
        "mask_lengths": (lambda: sa.sparse_fwd_cuda(q[:, :, :16], kv, kv, mask),
                         "do not match the BlockMask"),
        "wider_than_128": (lambda: sa.sparse_fwd_cuda(*(torch.zeros(1, 2, 32, 136),) * 3, mask),
                           "up to 128"),
        "do_shape": (lambda: bwd(q, kv, kv, q[:, :, :, :4], lse, lse), "dO shape"),
        "lse_shape": (lambda: bwd(q, kv, kv, q, lse[:, :2], lse), "lse must be"),
        "delta_dtype": (lambda: sa.sparse_bwd_dkv_cuda(q, kv, kv, q, lse, lse.double(), mask),
                        "delta must be"),
        "cpu_tensors": (lambda: sa.sparse_bwd_dkv_cuda(q, kv, kv, q, lse, lse, mask),
                        "CUDA tensors"),
    }[name]


@pytest.mark.parametrize("name", ["not_4d", "heads_not_a_multiple", "widths_do_not_fit",
                                  "mask_lengths", "wider_than_128", "do_shape", "lse_shape",
                                  "delta_dtype", "cpu_tensors"])
def test_launch_refuses_without_a_card(name):
    call, message = _refused(name)
    launches = [f.launches for f in (sa.sparse_fwd_cuda, sa.sparse_bwd_dq_cuda,
                                     sa.sparse_bwd_dkv_cuda)]
    with pytest.raises(ValueError, match=message):
        call()
    assert launches == [f.launches for f in (sa.sparse_fwd_cuda, sa.sparse_bwd_dq_cuda,
                                             sa.sparse_bwd_dkv_cuda)]


def _layout(name):
    """A bf16 tensor of shape (2, 4, 8, D) in layout `name`."""
    x = torch.arange(2 * 4 * 8 * 40, dtype=torch.float32).bfloat16()
    if name == "contiguous":
        return x.view(2, 4, 8, 40)
    if name == "autograd_do":  # (B, N, H, Dv) seen through the heads' transpose
        return x.view(2, 8, 4, 40).transpose(1, 2)
    if name == "single_batch_odd_stride":  # an axis of 1 may have any stride
        return torch.as_strided(x, (1, 4, 8, 40), (7, 320, 40, 1))
    if name == "stride_along_d":
        return x.view(2, 4, 8, 40)[..., ::2]
    if name == "start_off_16_bytes":
        return x[1:1 + 2 * 4 * 8 * 32].view(2, 4, 8, 32)
    return x[:2 * 4 * 8 * 36].view(2, 4, 8, 36)  # "rows_72_bytes_apart"


@pytest.mark.parametrize("name,ready", [
    ("contiguous", True), ("autograd_do", True), ("single_batch_odd_stride", True),
    ("stride_along_d", False), ("start_off_16_bytes", False), ("rows_72_bytes_apart", False)])
def test_tensor_core_kernels_copy_rows_they_cannot_take(name, ready):
    """The rule by which the bf16 wrapper copies an input for the tensor-core
    kernels (16-byte row copies): a layout they take goes as it is; any other
    is copied, values unchanged, into rows padded to 8 elements."""
    t = _layout(name)
    assert sa._mma_ready(t) == ready
    got = sa._mma_rows(t)
    assert (got is t) == ready
    assert sa._mma_ready(got) and got.shape == t.shape and torch.equal(got, t)
    assert got.stride(-2) % 8 == 0 and got.stride(-2) >= t.shape[-1]
    assert sa.flash_route(torch.bfloat16, 32) == "mma"
    assert sa.flash_route(torch.float32, 32) == "f32"
