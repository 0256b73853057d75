"""``ku_torch.kernels.flash_attention.ring_attention`` on the CPU, against
``ku``'s single-device ``flash_attention`` on the global arrays.

Both impls (``"pallas"``: the flash kernels' plain versions hop by hop, merged
by log-sum-exp, and a second ring pass for the gradients; ``"xla"``: ``ku``'s
chunked online-softmax update in plain torch) run with W = 2 and W = 4 ranks
emulated in one process (``ring_attention_emulated``: the same per-hop code
in rank order) and with a gloo world of one process (the P2P ring, whose
rotation is then skipped); two processes are in
``tests/test_torch_multiprocess.py``. Cases: causal, causal with a sliding
window, GQA, packed segments with and without causality. Output and
dq/dk/dv agree with ``jax.grad`` of ``ku``'s ``flash_attention`` within
rtol/atol 2e-5 (f32, sums in another order). ``impl="xla"`` is also held
against ``ku``'s ``ring_attention(impl="xla")`` on a query row with no live
key at all (``ku``'s mean of V, padded keys included); ``ku``'s ``impl="pallas"`` ring is never
called (its interpret-mode ring is the flaky one). The ``"pallas"`` ring
gives such a row 0 and no gradient, as the port's single-device kernels do.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ku.dist import make_mesh as ku_make_mesh
from ku.pallas.flash_attention import flash_attention as ku_flash
from ku.pallas.flash_attention import ring_attention as ku_ring
import ku_torch.kernels.flash_attention as fa
from ku_torch.dist import make_mesh

TOL = dict(rtol=2e-5, atol=2e-5)
B, N, D, SCALE = 1, 16, 8, 0.3
SEGS = np.array([[0] * 5 + [1] * 7 + [2] * 4], np.int32)
CASES = {
    "causal": dict(h=4, hkv=4, causal=True),
    "window": dict(h=4, hkv=4, causal=True, window=5),
    "gqa": dict(h=4, hkv=2, causal=True),
    "segments": dict(h=2, hkv=2, causal=False, segment_ids=SEGS),
    "causal_segments": dict(h=4, hkv=2, causal=True, segment_ids=SEGS),
}


def _inputs(h, hkv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, h, N, D)).astype(np.float32)
    k = rng.normal(size=(B, hkv, N, D)).astype(np.float32)
    v = rng.normal(size=(B, hkv, N, D)).astype(np.float32)
    g = rng.normal(size=(B, h, N, D)).astype(np.float32)
    return q, k, v, g


def _kw(case):
    return {k: v for k, v in CASES[case].items() if k not in ("h", "hkv")}


@functools.lru_cache(maxsize=None)
def _ku_reference(case):
    """ku's single-device flash attention on the global arrays: (o, dq, dk,
    dv) of sum(o · g)."""
    c = CASES[case]
    q, k, v, g = _inputs(c["h"], c["hkv"])
    kw = _kw(case)
    seg = kw.pop("segment_ids", None)
    seg = None if seg is None else jnp.asarray(seg)

    def f(q, k, v):
        o = ku_flash(q, k, v, softmax_scale=SCALE, segment_ids=seg, **kw)
        return (o * g).sum(), o

    (_, o), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (o,) + tuple(grads)


def _port(fn, case, **call):
    c = CASES[case]
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(c["h"], c["hkv"]))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    kw = _kw(case)
    o = fn(q, k, v, softmax_scale=SCALE, **kw, **call)
    return (o,) + torch.autograd.grad((o * g).sum(), (q, k, v))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("case", list(CASES))
def test_emulated_ring_matches_ku(case, impl, world):
    got = _port(fa.ring_attention_emulated, case, world=world, impl=impl, chunk=3)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, _ku_reference(case)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), err_msg=name, **TOL)


@pytest.fixture
def world_of_one():
    assert not dist.is_initialized()
    mesh = make_mesh(devices="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_p2p_ring_of_one_matches_ku(world_of_one, impl):
    for case in ("causal_segments", "window"):
        got = _port(fa.ring_attention, case, mesh=world_of_one, impl=impl)
        for name, a, b in zip(("o", "dq", "dk", "dv"), got, _ku_reference(case)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       err_msg=f"{case} {name}", **TOL)


def test_every_rank_launches_every_hop(monkeypatch):
    """W forward launches and W of each backward kernel per rank and call,
    dead hops (wholly in a rank's causal future) included, as in ku."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_fwd, fa._bwd_hop

    def count_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(fa, "flash_fwd", count_fwd)
    monkeypatch.setattr(fa, "_bwd_hop", count_bwd)
    _port(fa.ring_attention_emulated, "causal", world=4)
    assert calls == {"fwd": 16, "bwd": 16}


def test_rows_with_no_live_key():
    """Query segment 9 meets no key. "xla" gives ku's ring's mean of V there,
    padded keys included (its plain math); "pallas" gives 0 and no gradient, as the port's
    single-device flash attention does, and its other rows equal ku's."""
    q, k, v, g = _inputs(2, 2, seed=1)
    seg_q = SEGS.copy()
    seg_q[0, 3:5] = 9
    segs = (seg_q, SEGS)
    want = ku_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ku_make_mesh({"data": 2}),
                   softmax_scale=SCALE, chunk=3, impl="xla",
                   segment_ids=(jnp.asarray(seg_q), jnp.asarray(SEGS)))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got = fa.ring_attention_emulated(*t, 2, softmax_scale=SCALE, chunk=3, impl="xla",
                                     segment_ids=segs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # Every score of the row is -1e30: each of the 2 hops' 3 chunks of 3
    # keys (one of them padding) weighs 1, so the row is ΣV / 18.
    np.testing.assert_allclose(got[0, :, 3:5].numpy(),
                               np.broadcast_to(v.sum(axis=2, keepdims=True) / 18, (1, 2, 2, D))[0],
                               **TOL)

    qt, kt, vt = (x.clone().requires_grad_() for x in t)
    ring = fa.ring_attention_emulated(qt, kt, vt, 2, softmax_scale=SCALE, segment_ids=segs)
    got = (ring,) + torch.autograd.grad((ring * torch.from_numpy(g)).sum(), (qt, kt, vt))
    qt, kt, vt = (x.clone().requires_grad_() for x in t)
    one = fa.flash_attention(qt, kt, vt, softmax_scale=SCALE, segment_ids=segs)
    want = (one,) + torch.autograd.grad((one * torch.from_numpy(g)).sum(), (qt, kt, vt))
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), err_msg=name, **TOL)
    assert not got[0][0, :, 3:5].any() and not got[1][0, :, 3:5].any()


def test_value_errors():
    q = torch.zeros(1, 2, 6, 4)
    with pytest.raises(ValueError, match="window requires causal"):
        fa.ring_attention_emulated(q, q, q, 2, window=2)
    with pytest.raises(ValueError, match="does not divide"):
        fa.ring_attention_emulated(q, q, q, 4)
    with pytest.raises(ValueError, match="impl"):
        fa.ring_attention_emulated(q, q, q, 2, impl="mosaic")
