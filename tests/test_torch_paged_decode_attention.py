"""The plain version of ku_torch's paged flash-decoding kernel against ku's
Pallas kernel in interpret mode, on the CPU, for every ``pipelined`` variant.

Same numpy-made inputs on both sides. f32 at rtol 2e-5 / atol 1e-6, ku's own
limit for its kernel against its oracle (the two fold the slots in another
order); bf16 at rtol 1e-2 / atol 2e-3 (the probabilities round to bf16
against another running max). Cases: permuted tables whose dead tails point
at a pool page poisoned with NaN (or NaN scales, for int8 pools), a length
past the table's end, softcap, int8 pools with scales. The kernel itself is
held against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ku.pallas.decode_attention import decode_attention_paged as ku_paged
from ku_torch.kernels import decode_attention as da

F32 = dict(rtol=2e-5, atol=1e-6)
BF16 = dict(rtol=1e-2, atol=2e-3)
B, HKV, G, D, PG, MP = 3, 2, 4, 8, 4, 5


@functools.lru_cache(maxsize=None)
def _ku(pipelined, softcap, quant):
    def run(q, kp, vp, table, lengths, ks, vs):
        return ku_paged(q, kp, vp, table, lengths, k_scale=ks, v_scale=vs,
                        softmax_scale=0.3, logit_softcap=softcap,
                        interpret=True, pipelined=pipelined)
    if not quant:
        return jax.jit(lambda q, kp, vp, t, n: run(q, kp, vp, t, n, None, None))
    return jax.jit(run)


def _inputs(rng, lengths, quant, dtype=np.float32):
    """A pool of B·MP + 1 pages in permuted order; the one page no row
    owns is poisoned and every row's dead table tail points at it."""
    n_pool = B * MP + 1
    q = rng.normal(size=(B, HKV, G, D)).astype(np.float32)
    table = rng.permutation(n_pool)
    poison, table = int(table[-1]), table[:-1].reshape(B, MP).astype(np.int32)
    for row, n in enumerate(lengths):
        table[row, max(0, -(-n // PG)):] = poison
    ks = vs = None
    if quant:
        kp = rng.integers(-127, 128, size=(n_pool, HKV, D, PG)).astype(np.int8)
        vp = rng.integers(-127, 128, size=(n_pool, HKV, D, PG)).astype(np.int8)
        ks = rng.uniform(0.01, 0.05, size=(n_pool, HKV, PG)).astype(np.float32)
        vs = rng.uniform(0.01, 0.05, size=(n_pool, HKV, PG)).astype(np.float32)
        ks[poison] = vs[poison] = np.nan
    else:
        kp = rng.normal(size=(n_pool, HKV, D, PG)).astype(np.float32)
        vp = rng.normal(size=(n_pool, HKV, D, PG)).astype(np.float32)
        kp[poison] = vp[poison] = np.nan
    return q, kp, vp, table, np.asarray(lengths, np.int32), ks, vs


def _both(inputs, pipelined, softcap, dtype_t, dtype_j):
    q, kp, vp, table, lengths, ks, vs = inputs
    quant = ks is not None
    cast_j = (lambda a: jnp.asarray(a)) if quant else (
        lambda a: jnp.asarray(a).astype(dtype_j))
    args = [jnp.asarray(q).astype(dtype_j), cast_j(kp), cast_j(vp),
            jnp.asarray(table), jnp.asarray(lengths)]
    if quant:
        args += [jnp.asarray(ks), jnp.asarray(vs)]
    want = np.asarray(_ku(pipelined, softcap, quant)(*args).astype(jnp.float32))
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    cast_t = (lambda a: t(a)) if quant else (lambda a: t(a).to(dtype_t))
    before = da.decode_attention_paged_cuda.launches
    got = da.decode_attention_paged(
        t(q).to(dtype_t), cast_t(kp), cast_t(vp), t(table), t(lengths),
        k_scale=t(ks), v_scale=t(vs), softmax_scale=0.3, logit_softcap=softcap,
        pipelined=pipelined)
    assert da.decode_attention_paged_cuda.launches == before  # CPU: plain
    assert got.dtype == dtype_t
    out = got.float().numpy()
    assert np.isfinite(out).all()
    return out, want


CASES = {
    # Ragged lengths: 1 slot, a page boundary, a full table.
    "permuted_poisoned": dict(lengths=[1, 8, MP * PG], quant=False, softcap=None),
    "int8_poisoned_scales": dict(lengths=[6, 13, 19], quant=True, softcap=None),
    # Lengths past MP·pg read the whole window unmasked.
    "softcap_overrun": dict(lengths=[MP * PG + 3, 11, MP * PG + 40], quant=False,
                            softcap=2.0),
}


@pytest.mark.parametrize("pipelined", [False, True, "v4"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_paged_matches_ku_interpret_f32(rng, case, pipelined):
    c = CASES[case]
    got, want = _both(_inputs(rng, c["lengths"], c["quant"]), pipelined,
                      c["softcap"], torch.float32, jnp.float32)
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("pipelined", [False, "v4"])
def test_plain_paged_matches_ku_interpret_bf16(rng, pipelined):
    got, want = _both(_inputs(rng, [3, 12, 17], False), pipelined, None,
                      torch.bfloat16, jnp.bfloat16)
    np.testing.assert_allclose(got, want, **BF16)


def test_identity_table_is_the_dense_read(rng):
    """pg = S with an identity table: the paged read is the dense one."""
    q = torch.from_numpy(rng.normal(size=(2, 2, 4, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 2, 8, 12)).astype(np.float32))
            for _ in range(2))
    lengths = torch.tensor([5, 12], dtype=torch.int32)
    table = torch.arange(2, dtype=torch.int32)[:, None]
    torch.testing.assert_close(
        da.decode_attention_paged(q, k, v, table, lengths),
        da.decode_attention(q, k, v, lengths), rtol=0, atol=0)


def test_rows_of_length_zero_are_zero_and_read_nothing(rng):
    q, kp, vp, table, _, _, _ = _inputs(rng, [0, 7, -2], False)
    table[0, :] = table[2, :] = 10 ** 6  # dead: any value, never read
    out = da.decode_attention_paged(*(torch.from_numpy(a) for a in (q, kp, vp)),
                                    torch.from_numpy(table),
                                    torch.tensor([0, 7, -2], dtype=torch.int32))
    assert torch.all(out[0] == 0) and torch.all(out[2] == 0)
    assert torch.isfinite(out).all() and torch.all(out[1].abs().sum(-1) > 0)


def test_paged_wrapper_refuses_what_the_kernel_does_not_take(rng):
    q, kp, vp, table, lengths, ks, vs = (
        None if a is None else torch.from_numpy(a)
        for a in _inputs(rng, [3, 4, 5], True))
    with pytest.raises(ValueError, match="CUDA tensors"):
        da.decode_attention_paged_cuda(q, kp, vp, table, lengths, k_scale=ks,
                                       v_scale=vs)
    with pytest.raises(ValueError, match="int8 caches"):
        da.decode_attention_paged(q, kp, vp, table, lengths)
    with pytest.raises(ValueError, match="page_table shape"):
        da.decode_attention_paged(q, kp, vp, table[:2], lengths, k_scale=ks,
                                  v_scale=vs)
    with pytest.raises(ValueError, match="scales must be"):
        da.decode_attention_paged(q, kp, vp, table, lengths, k_scale=ks[:, :1],
                                  v_scale=vs)
