"""A CPU model of the decode kernels' split and merge (kernels #6 and #7).

On the card each (row, KV head) is a cluster of ``S_SPLIT`` blocks: block r
folds chunk r of ``split_plan(length)`` on its own and the blocks merge
their partials (m, l, acc) in the fixed order 0..S_SPLIT-1. Here each chunk
is folded by the plain version's arithmetic over that chunk's slots alone
(an empty chunk gives the kernel's empty partial: m = -1e30, l = 0,
acc = 0) and the partials are merged in that order, as the kernel does.
The result is held against the one-pass plain version (f32: rtol/atol 1e-5,
the same sums in another order; bf16: the card's limits, rtol 1e-2 / atol
2e-3, since each chunk rounds its probabilities against its own max) and
against ku's Pallas kernels in interpret mode on one tiny dense and one
tiny paged case (ku's own limits for its kernels: f32 rtol 2e-5 / atol
1e-6 paged, 1e-5 dense). The plan itself: chunks that cover [0, length)
once, start on a tile, at most S_SPLIT of them, and depend on the length
alone. The kernel's own plan is held against ``split_plan`` on the card
(tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ku.pallas.decode_attention import decode_attention as ku_decode
from ku.pallas.decode_attention import decode_attention_paged as ku_paged
from ku_torch.kernels import decode_attention as da

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=2e-3)
EDGES = [0, -1, 1, 63, 64, 65, 511, 512, 513, 1000, 1024, 1124, 4097]


@pytest.mark.parametrize("length", EDGES + list(range(2, 2000, 37)))
def test_split_plan_covers_the_live_prefix_once(length):
    plan = da.split_plan(length)
    assert len(plan) == da.S_SPLIT
    live = [(lo, hi) for lo, hi in plan if lo < hi]
    assert len(live) <= da.S_SPLIT
    assert all(lo % da.TILE == 0 for lo, _ in live)
    assert all(hi - lo == da.split_chunk(length) for lo, hi in live[:-1])
    slots = [s for lo, hi in live for s in range(lo, hi)]
    assert slots == list(range(max(length, 0)))
    # The blocks past the live prefix get empty chunks and read nothing.
    assert all(lo == hi == max(length, 0) for lo, hi in plan[len(live):])


def _fold_chunk(q, k, v, lo, hi, ks, vs, scale, cap):
    """One block's partial over slots [lo, hi) of one row: (m, l, acc) per
    head, unnormalised, the probabilities rounded to q's dtype before the PV
    product. q (Hkv, G, D), k (Hkv, D, S), v (Hkv, Dv, S)."""
    hkv, g, _ = q.shape
    if lo >= hi:
        return (torch.full((hkv, g), -1e30), torch.zeros(hkv, g),
                torch.zeros(hkv, g, v.shape[1]))
    s = torch.einsum("hgd,hds->hgs", q.float(), k[..., lo:hi].to(q.dtype).float())
    if ks is not None:
        s = s * ks[:, None, lo:hi]
    s = s * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    if vs is not None:
        p = p * vs[:, None, lo:hi]
    p = p.to(q.dtype).float()
    return m, l, torch.einsum("hgs,hds->hgd", p, v[..., lo:hi].to(q.dtype).float())


def split_read(q, k, v, lengths, k_scale=None, v_scale=None, scale=0.3, cap=None):
    """The dense read as the kernel splits and merges it, row by row."""
    out = torch.empty(*q.shape[:3], v.shape[2], dtype=q.dtype)
    for b in range(q.shape[0]):
        length = min(int(lengths[b]), k.shape[3])
        parts = [_fold_chunk(q[b], k[b], v[b], lo, hi,
                             None if k_scale is None else k_scale[b],
                             None if v_scale is None else v_scale[b], scale, cap)
                 for lo, hi in da.split_plan(length)]
        big_m = parts[0][0]
        for m, _, _ in parts[1:]:
            big_m = torch.maximum(big_m, m)
        big_l, acc = torch.zeros_like(big_m), torch.zeros_like(parts[0][2])
        for m, l, a in parts:  # blocks 0..S_SPLIT-1, in order
            w = torch.exp(m - big_m)
            big_l = big_l + l * w
            acc = acc + a * w[..., None]
        out[b] = (acc / big_l.clamp(min=1e-30)[..., None]).to(q.dtype)
    return out


def _dense(rng, b, hkv, g, d, dv, s, quant):
    q = rng.normal(size=(b, hkv, g, d)).astype(np.float32)
    if quant:
        k = rng.integers(-127, 128, size=(b, hkv, d, s)).astype(np.int8)
        v = rng.integers(-127, 128, size=(b, hkv, dv, s)).astype(np.int8)
        ks, vs = (rng.uniform(0.001, 0.02, size=(b, hkv, s)).astype(np.float32)
                  for _ in range(2))
        return q, k, v, ks, vs
    k = rng.normal(size=(b, hkv, d, s)).astype(np.float32)
    v = rng.normal(size=(b, hkv, dv, s)).astype(np.float32)
    return q, k, v, None, None


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # Every edge of the plan over a 1,124-slot cache: empty chunks, a row of
    # length 0 and -1, a chunk cut at the length, the length past S.
    dict(g=4, d=16, dv=16, s=1124, lengths=EDGES[:-1], quant=False, cap=None),
    # int8 with softcap, G 1, Dv < D.
    dict(g=1, d=16, dv=8, s=700, lengths=[0, 65, 513, 699, 700, 900], quant=True,
         cap=2.0),
])
def test_split_and_merge_is_the_one_pass_read(case, dtype):
    rng = np.random.default_rng(0)
    c = case
    q, k, v, ks, vs = _dense(rng, len(c["lengths"]), 2, c["g"], c["d"], c["dv"], c["s"],
                             c["quant"])
    lengths = torch.tensor(c["lengths"], dtype=torch.int32)
    cast = (lambda a: _t(a)) if c["quant"] else (lambda a: _t(a).to(dtype))
    args = (_t(q).to(dtype), cast(k), cast(v), lengths)
    kw = dict(k_scale=_t(ks), v_scale=_t(vs))
    got = split_read(*args, **kw, scale=0.3, cap=c["cap"])
    want = da.decode_attention_torch(*args, **kw, softmax_scale=0.3,
                                     logit_softcap=c["cap"])
    torch.testing.assert_close(got, want, **(F32 if dtype == torch.float32 else BF16))
    assert torch.all(got[lengths <= 0] == 0)


def test_split_and_merge_matches_ku_dense():
    rng = np.random.default_rng(1)
    q, k, v, _, _ = _dense(rng, 2, 1, 2, 8, 8, 192, False)
    lengths = np.asarray([150, 192], np.int32)
    want = ku_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
                     softmax_scale=0.3, block_t=64, interpret=True)
    got = split_read(_t(q), _t(k), _t(v), _t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_split_and_merge_matches_ku_paged():
    """Pages of 32 slots in permuted order; each row's split runs over its
    gathered view, as the kernel's chunks run over its table."""
    rng = np.random.default_rng(2)
    b, hkv, g, d, pg, mp = 2, 1, 2, 8, 32, 6
    q = rng.normal(size=(b, hkv, g, d)).astype(np.float32)
    kp, vp = (rng.normal(size=(b * mp, hkv, d, pg)).astype(np.float32) for _ in range(2))
    table = rng.permutation(b * mp).reshape(b, mp).astype(np.int32)
    lengths = np.asarray([150, 70], np.int32)
    want = ku_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
                    jnp.asarray(lengths), softmax_scale=0.3, interpret=True)
    view = [da.gather_pages(_t(x), _t(table)) for x in (kp, vp)]
    got = split_read(_t(q), *view, _t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-6)
