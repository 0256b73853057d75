"""The port's multi-device paths in a real two-process gloo world on the CPU,
each held against the same call in one process.

One test function spawns two ranks (``torch.distributed`` over gloo, a
``FileStore``) that run, in turn:

- ``ring_attention`` over a ``{"data": 2}`` mesh, both impls: the real P2P
  rotation (``batch_isend_irecv``) and the gathers, output and dq/dk/dv;
- ``ContinuousBatcher(mesh=)`` at ``{"model": 2}`` (head-parallel: each rank
  two of the four query heads and one of the two KV heads, dense and paged
  caches, an all-reduce closing ``W_multi_head`` and ``Dense_1``) and at
  ``{"data": 2, "model": 1}`` (the slots split, the logits gathered; dense
  and paged);
  ``shard_decode_state`` warning on heads that do not divide;
- one ``GAN.fit_generator`` step (softplus with R1, so gradients of
  gradients cross the collectives) of a StyleGAN with truncation and the
  minibatch-stddev layer, at ``{"data": 2}`` (two rows a rank of a batch of
  four, so the stddev group straddles the ranks) and at ``{"model": 2}``
  (the mapping, style and dense_1 kernels split by column), and one
  ``fit_generator_progressively`` stage at ``{"model": 2}``.

The two ranks' results agree with each other and with the one-process run:
the ring within rtol/atol 2e-5 of ``ring_attention_emulated`` at W = 2 (f32),
the batcher's greedy ids exactly and its logprobs within 1e-5, the GAN's
losses, parameters and truncation mean within 1e-5 (Adam at eps 1, whose
step lr·g/(|g| + 1) follows the gradient: at eps 1e-8 it is lr·sign(g),
which hides a wrong gradient and turns a near-zero gradient summed in
another order into a 2·lr move). One test
function, because ``--dist load`` would build a module fixture once per
worker; the spawned ranks import this module, which imports no jax.
"""

import multiprocessing as mp
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

import ku_torch.dist as pd
import ku_torch.kernels.flash_attention as fa
from ku_torch.backprop import GAN
from ku_torch.backprop.gan import STYLE_GAN_SOFTPLUS_INVERSE_R1_GP
from ku_torch.engine_ext import adam
from ku_torch.models import StyleGANDiscriminator, StyleGANGenerator
from ku_torch.nn import ContinuousBatcher, Transformer
from ku_torch.utility import variables_from_module

TOL = dict(rtol=2e-5, atol=2e-5)
GAN_TOL = dict(rtol=1e-5, atol=1e-5)
VOCAB, D, MAX_LEN = 48, 16, 32
GEN = dict(resolution=8, ch_base=32, max_ch=8, latent_dim=8, dlatent_dim=8, dense1_dim=8,
           num_mapping_layers=3, label_usage=False, mixing_prob=0.9, trunc_psi=0.7,
           trunc_cutoff=2)
DISC = dict(resolution=8, ch_base=32, max_ch=8, label_usage=False)
GAN_B = 4


# -- the three workloads, each a function of the mesh (None: one process) -----


def _ring(mesh, impl):
    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in ((1, 4, 16, 8), (1, 2, 16, 8), (1, 2, 16, 8), (1, 4, 16, 8)))
    segs = torch.tensor([[0] * 5 + [1] * 7 + [2] * 4])
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    kw = dict(softmax_scale=0.3, causal=True, segment_ids=segs, impl=impl, chunk=3)
    o = (fa.ring_attention(q, k, v, mesh, **kw) if mesh is not None
         else fa.ring_attention_emulated(q, k, v, 2, **kw))
    return [x.detach().numpy() for x in (o,) + torch.autograd.grad((o * g).sum(), (q, k, v))]


class LM(torch.nn.Module):
    def __init__(self, **kw):
        super().__init__()
        for i in range(2):
            self.add_module(f"block{i}", Transformer(
                4, D, causal=True, rope=True, num_kv_head=2, max_decode_len=MAX_LEN,
                device="cpu", generator=torch.Generator().manual_seed(10 + i), **kw))

    def forward(self, xs, decode=False, prompt_lengths=None, cache=None):
        x = xs[0]
        for i in range(2):
            x, cache = getattr(self, f"block{i}")([x], decode=decode, cache=cache,
                                                  prompt_lengths=prompt_lengths,
                                                  scope=f"block{i}")
        return x, cache


def _serve(mesh=None, **kw):
    """Greedy ids and logprobs of 5 requests through 4 slots (recycled),
    prompts longer than the prefill width included."""
    paged = kw.pop("paged", False)
    lm = LM(**(dict(kv_page_size=4, kv_num_pages=30) if paged else {}))
    table = torch.from_numpy(np.random.default_rng(3).normal(size=(VOCAB, D)).astype(np.float32))
    cb = ContinuousBatcher(lm, embed=lambda ids, pos=None: table[ids],
                           readout=lambda y: y @ table.T, num_slots=4, prompt_len=4,
                           max_decode_len=MAX_LEN, chunk=2, return_logprobs=True,
                           mesh=mesh, **kw)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, VOCAB, size=(n,)) for n in (3, 6, 2, 9, 5)]
    out = cb.serve(prompts, [5, 7, 4, 6, 8])
    return [t for t, _ in out], [lp for _, lp in out]


def _gan_batches():
    rng = np.random.default_rng(5)
    for _ in range(100):
        z = tuple(rng.normal(size=(GAN_B, 8)).astype(np.float32) for _ in range(2))
        yield {"x": rng.normal(size=(GAN_B, 8, 8, 3)).astype(np.float32), "z": z}


def _gan(mesh=None, progressive=False):
    """One softplus-R1 step (k = 1); the losses and the whole parameters."""
    conf = {"hps": {"composing_mode": STYLE_GAN_SOFTPLUS_INVERSE_R1_GP, "disc_k_step": 1,
                    "batch_step": 1, "epochs": 1, "r_gamma": 10.0},
            "nn_arch": {"gen_rng_streams": ["noise", "style"]}}

    def modules():
        torch.manual_seed(0)
        return (StyleGANGenerator(**GEN, device="cpu"),
                StyleGANDiscriminator(**DISC, device="cpu"))

    engine = GAN(conf, *modules()).compose_gan_with_mode()
    engine.compile(adam(1e-2, b1=0.0, b2=0.99, eps=1.0), adam(1e-2, b1=0.0, b2=0.99, eps=1.0))
    if progressive:
        hist = engine.fit_generator_progressively(
            lambda e, g, d: modules() + (_gan_batches(),), verbose=0, mesh=mesh)[0]
    else:
        hist = engine.fit_generator(_gan_batches(), verbose=0, mesh=mesh)
    out = {"d_loss": np.array(hist["disc_ext_loss"]), "g_loss": np.array(hist["gen_disc_loss"])}
    trees = dict(engine._param_trees(), gen_stats=variables_from_module(engine.gen)["batch_stats"])
    for side, tree in trees.items():
        flat = {}

        def walk(t, path):
            for key, val in t.items():
                if isinstance(val, dict):
                    walk(val, f"{path}/{key}")
                else:
                    flat[f"{side}{path}/{key}"] = np.asarray(val)

        walk(tree, "")
        out.update(flat)
    return out


def _rank_main(rank, store_path, out_path):
    torch.set_num_threads(1)
    pd.initialize_multihost(backend="gloo", rank=rank, world_size=2,
                            store=dist.FileStore(store_path, 2))
    out = {}
    ring_mesh = pd.make_mesh({"data": 2})
    for impl in ("pallas", "xla"):
        for i, x in enumerate(_ring(ring_mesh, impl)):
            out[f"ring_{impl}_{i}"] = x
    for name, kw in (("model", dict(mesh=pd.make_mesh({"model": 2}), num_head=4,
                                    num_kv_head=2)),
                     ("paged", dict(mesh=pd.make_mesh({"model": 2}), paged=True)),
                     ("data", dict(mesh=pd.make_mesh({"data": 2, "model": 1}),
                                   data_axis="data")),
                     ("paged_data", dict(mesh=pd.make_mesh({"data": 2, "model": 1}),
                                         data_axis="data", paged=True))):
        ids, lps = _serve(**kw)
        for i, (t, lp) in enumerate(zip(ids, lps)):
            out[f"serve_{name}_ids{i}"], out[f"serve_{name}_lp{i}"] = t, lp
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        lm = LM()
        ok = pd.parallel.shard_heads_(lm, pd.make_mesh({"model": 2}), num_head=3)
    out["fallback"] = np.array([not ok, any("replicated" in str(w.message) for w in caught),
                                lm.block0.MultiHeadAttention_0.parallel is None])
    for name, axes, prog in (("gan_data", {"data": 2}, False),
                             ("gan_model", {"model": 2}, False),
                             ("prog_model", {"model": 2}, True)):
        for key, val in _gan(pd.make_mesh(axes), prog).items():
            out[f"{name}:{key}"] = val
    dist.destroy_process_group()
    np.savez(out_path, **out)


def test_two_process_gloo_world(tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp_path / "store"), str(tmp_path / f"rank{r}.npz")))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(120)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    assert not alive, "a rank did not finish within 120 s"
    assert [p.exitcode for p in procs] == [0, 0]
    out = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for key in out[0]:
        np.testing.assert_allclose(out[0][key], out[1][key], err_msg=key, rtol=0, atol=0)
    got = out[0]

    for impl in ("pallas", "xla"):
        for i, want in enumerate(_ring(None, impl)):
            np.testing.assert_allclose(got[f"ring_{impl}_{i}"], want, err_msg=f"{impl} {i}",
                                       **TOL)

    for name, kw in (("model", {}), ("paged", dict(paged=True)), ("data", {}),
                     ("paged_data", dict(paged=True))):
        ids, lps = _serve(**kw)
        for i, (t, lp) in enumerate(zip(ids, lps)):
            np.testing.assert_array_equal(got[f"serve_{name}_ids{i}"], t, err_msg=name)
            np.testing.assert_allclose(got[f"serve_{name}_lp{i}"], lp, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    assert got["fallback"].all()

    want = _gan()
    for name in ("gan_data", "gan_model"):
        for key, val in want.items():
            np.testing.assert_allclose(got[f"{name}:{key}"], val, err_msg=f"{name} {key}",
                                       **GAN_TOL)
    for key, val in _gan(progressive=True).items():
        np.testing.assert_allclose(got[f"prog_model:{key}"], val, err_msg=key, **GAN_TOL)
