"""ku_torch's kernels on the card against their plain versions: the CD
kernel here, the serving kernels (flash forward, flash decoding), the
training ones (the flash backward, a Trainer step), the block-sparse
ones (forward, dq, dk/dv, a Trainer step under a block mask) and the
data-parallel CD step kernels (with RBM.fit(mesh=) in an NCCL world of one
process) below; then StyleGAN and the GAN step, and the layer-spec engine
(a Stack in f32 against float64 on the CPU, a batch-statistics Trainer),
checkpoints of a card state and the resize; the int8 KV cache's scales
against the CPU's bit for bit, a NobodyConvNet2D step on cuDNN against
float64, export and its refusal of a flash block, the native loader.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernel is built
with nvcc at first use) and skip without one. They import nothing of JAX,
so on a machine without it run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes are deliberately ragged (widths that are not multiples of 32, more
batch rows than a warp, a short last batch) to exercise the kernel's
bounds checks. With saturated parameters every draw is certain, so kernel
and plain version must agree to rounding (rtol 1e-5 / atol 1e-6). With
random parameters both draw the same Philox numbers; float32 sums taken in
another order can still move a Bernoulli threshold by an ulp, which these
few steps at these sizes do not meet: params rtol 1e-5 / atol 1e-5, scores
rtol 1e-4 / atol 1e-4.
"""

import copy

import numpy as np
import pytest
import torch

from ku_torch.ebm import RBM
from ku_torch.kernels import cd_gibbs

pytestmark = pytest.mark.cuda
NAMES = ("rbm_weight", "hidden_bias", "visible_bias")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(device, v_dim, h_dim, batch, steps, mode, saturated, seed=0):
    rng = np.random.default_rng(seed)
    if saturated:
        w = np.zeros((v_dim, h_dim))
        bh = np.where(np.arange(h_dim) % 2 == 0, 200.0, -200.0)
        bv = np.where(np.arange(v_dim) % 3 == 0, 200.0, -200.0)
    else:
        w = rng.normal(scale=0.1, size=(v_dim, h_dim))
        bh = rng.normal(scale=0.1, size=h_dim)
        bv = rng.normal(scale=0.1, size=v_dim)
    n = batch * steps - batch // 3 - 1
    if mode == cd_gibbs.MODE_VISIBLE_BERNOULLI:
        data = (rng.random((batch * steps, v_dim)) < 0.3).astype(np.float32)
    else:
        data = rng.normal(size=(batch * steps, v_dim)).astype(np.float32)
    data[n:] = 0.0
    mask = (np.arange(batch * steps) < n).astype(np.float32)
    params = {name: torch.tensor(x, dtype=torch.float32, device=device)
              for name, x in zip(NAMES, (w, bh, bv))}
    return params, torch.from_numpy(data).to(device), torch.from_numpy(mask).to(device)


def _compare(device, v_dim, h_dim, batch, steps, epochs, k, mode, saturated,
             p_tol, s_tol):
    params, v_all, mask = _problem(device, v_dim, h_dim, batch, steps, mode,
                                   saturated)
    args = (params, v_all, mask, 1234, 1e-3, k, mode, batch, epochs)
    p_k, s_k = cd_gibbs.cd_train_cuda(*args)
    torch.cuda.synchronize()
    p_p, s_p = cd_gibbs.cd_train_torch(*args)
    for name in NAMES:
        torch.testing.assert_close(p_k[name], p_p[name], rtol=p_tol[0],
                                   atol=p_tol[1], msg=name)
    torch.testing.assert_close(s_k, s_p, rtol=s_tol[0], atol=s_tol[1])
    assert torch.isfinite(s_k).all()


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("shape", [(37, 45, 40, 3), (6, 4, 16, 4), (200, 70, 150, 2)])
def test_kernel_matches_plain_when_forced(device, shape, k):
    v_dim, h_dim, batch, steps = shape
    _compare(device, v_dim, h_dim, batch, steps, 2, k,
             cd_gibbs.MODE_VISIBLE_BERNOULLI, True, (1e-5, 1e-6), (1e-5, 1e-6))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_kernel_matches_plain_with_shared_draws(device, mode, k):
    _compare(device, 37, 45, 40, 3, 1, k, mode, False, (1e-5, 1e-5), (1e-4, 1e-4))


def test_kernel_rejects_what_it_does_not_take(device):
    params, v_all, mask = _problem(device, 8, 4, 4, 2, 0, True)
    with pytest.raises(ValueError, match="float32"):
        cd_gibbs.cd_train_cuda(params, v_all.double(), mask, 0, 1e-3, 1, 0, 4, 1)
    with pytest.raises(ValueError, match="multiple"):
        cd_gibbs.cd_train_cuda(params, v_all[:7], mask[:7], 0, 1e-3, 1, 0, 4, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cd_gibbs.cd_train_cuda(params, v_all.cpu(), mask, 0, 1e-3, 1, 0, 4, 1)


# Both routes of kernel #1 (the cluster route, at 16 blocks and at 8, and
# the global route) against the plain version at the cases above, plus V =
# 100, which 16 and 8 blocks do not divide, and the RBM's shape.
ROUTE_CASES = ([(37, 45, 40, 3, 2, 1, 0, True), (6, 4, 16, 4, 2, 2, 0, True),
                (200, 70, 150, 2, 2, 1, 0, True), (100, 128, 64, 3, 2, 1, 0, True)]
               + [(37, 45, 40, 3, 1, k, mode, False) for mode in (0, 1, 2) for k in (1, 3)]
               + [(100, 128, 64, 3, 1, 1, 0, False), (784, 128, 128, 2, 1, 1, 0, False)])


def _route_compare(device, case, route, cluster=None):
    v_dim, h_dim, batch, steps, epochs, k, mode, saturated = case
    tol = ((1e-5, 1e-6), (1e-5, 1e-6)) if saturated else ((1e-5, 1e-5), (1e-4, 1e-4))
    params, v_all, mask = _problem(device, v_dim, h_dim, batch, steps, mode, saturated)
    args = (params, v_all, mask, 1234, 1e-3, k, mode, batch, epochs)
    p_k, s_k = cd_gibbs.cd_train_cuda(*args, route=route, cluster=cluster)
    torch.cuda.synchronize()
    launch = cd_gibbs.last_launch()
    assert launch["route"] == route
    if route == "cluster":
        plan = cd_gibbs.cluster_plan(batch, v_dim, h_dim, cluster or 16)
        assert launch["cluster"] == launch["blocks"] == (cluster or 16)
        assert (launch["batch_tile"], launch["tiles"], launch["smem_bytes"]) == (
            plan["batch_tile"], plan["tiles"], plan["smem_bytes"])
    else:
        assert launch["blocks"] == cd_gibbs.grid_size(batch, v_dim, h_dim)
        assert launch["cluster"] == 0 and 0 < launch["smem_bytes"] <= cd_gibbs.SMEM_BUDGET
    p_p, s_p = cd_gibbs.cd_train_torch(*args)
    for name in NAMES:
        torch.testing.assert_close(p_k[name], p_p[name], rtol=tol[0][0], atol=tol[0][1],
                                   msg=name)
    torch.testing.assert_close(s_k, s_p, rtol=tol[1][0], atol=tol[1][1])


@pytest.mark.parametrize("route,cluster", [("cluster", None), ("cluster", 8), ("global", None)])
@pytest.mark.parametrize("case", ROUTE_CASES)
def test_each_route_matches_plain(device, case, route, cluster):
    _route_compare(device, case, route, cluster)


# The global route at the DBN's wide layers (784 x 500 and 500 x 2000 at
# batch 100, three steps, the last ragged and masked), which the cluster
# route cannot hold; CD-2 in Gaussian mode over two steps, the second ragged
# and masked (a third step takes these random weights from ~19 to ~600 and
# the plain version in float32 itself 2e-4 from float64); and a W too large
# for the grid's shared memory, whose tiles come from L2 once a product.
GLOBAL_CASES = [(784, 500, 100, 3, 1, 1, 0, False), (500, 2000, 100, 3, 1, 1, 0, False),
                (784, 500, 100, 2, 1, 2, 1, False), (8192, 2048, 8, 2, 1, 1, 0, True)]
# Batches whose rows do not fit a block's shared memory at once, so the
# plan takes them in chunks (its batch tile below the batch), the last batch
# ragged and masked: 300 rows in chunks of 176 at 784 x 500; 200 rows in
# chunks of 72 at 500 x 2000, CD-2, saturated (at 300 rows the first step's
# update would cancel b_v = 200 for a third of the visible units, which then
# sit near their thresholds: no longer saturated).
CHUNK_CASES = [(784, 500, 300, 2, 1, 1, 0, False), (500, 2000, 200, 2, 1, 2, 0, True)]


@pytest.mark.parametrize("case", GLOBAL_CASES + CHUNK_CASES)
def test_global_route_matches_plain_at_wide_shapes(device, case):
    v_dim, h_dim, batch = case[:3]
    assert cd_gibbs.route_for(batch, v_dim, h_dim) == "global"
    _route_compare(device, case, "global")
    assert (cd_gibbs.last_launch()["batch_tile"] < batch) == (case in CHUNK_CASES)


def test_a_global_run_is_one_cd_gibbs_kernel(device):
    # roofline.cd_global pairs each global launch with one such kernel.
    import re

    from torch.profiler import ProfilerActivity, profile

    params, v_all, mask = _problem(device, 784, 500, 100, 2, 0, False)
    cd_gibbs.cd_train_cuda(params, v_all, mask, 1, 1e-3, 1, 0, 100, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cd_gibbs.cd_train_cuda(params, v_all, mask, 1, 1e-3, 1, 0, 100, 1)
        torch.cuda.synchronize()
    assert cd_gibbs.last_launch()["route"] == "global"
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and re.search(r"\bcd_gibbs_kernel\b", e.name)]
    assert len(kernels) == 1, kernels


@pytest.mark.parametrize("shape", [(128, 784, 128), (128, 784, 256), (128, 256, 128),
                                   (40, 37, 45), (16, 6, 4), (32, 784, 128), (128, 4096, 1024)])
@pytest.mark.parametrize("cluster", [16, 8])
def test_c_entry_plan_is_cluster_plan(device, shape, cluster):
    want = cd_gibbs.cluster_plan(*shape, cluster)
    got = cd_gibbs.c_plan(*shape, cluster)
    if want["route"] == "global":
        assert got["smem_bytes"] == 0 and got["batch_tile"] == 0
    else:
        assert got == {key: want[key] for key in got}


def test_the_path_shape_launches_the_cluster_route(device):
    params, v_all, mask = _problem(device, 784, 128, 128, 2, 0, False)
    before = dict(cd_gibbs.cd_train_cuda.by_route)
    cd_gibbs.cd_train_cuda(params, v_all, mask, 1, 1e-3, 1, 0, 128, 1)
    torch.cuda.synchronize()
    launch = cd_gibbs.last_launch()
    assert launch["route"] == "cluster" and launch["cluster"] == 16
    assert launch["batch_tile"] == cd_gibbs.cluster_plan(128, 784, 128)["batch_tile"]
    assert cd_gibbs.cd_train_cuda.by_route["cluster"] == before["cluster"] + 1


def test_a_cluster_launch_past_the_budget_is_refused(device):
    params, v_all, mask = _problem(device, 4096, 1024, 8, 1, 0, True)
    assert cd_gibbs.route_for(8, 4096, 1024) == "global"
    with pytest.raises(RuntimeError, match="cluster route"):
        cd_gibbs.cd_train_cuda(params, v_all, mask, 1, 1e-3, 1, 0, 8, 1, route="cluster")


def test_rbm_fit_on_the_card_launches_the_kernel(device):
    rng = np.random.default_rng(1)
    data = (rng.random((300, 50)) < 0.2).astype(np.float32)
    before = cd_gibbs.cd_train_cuda.launches
    rbm = RBM({"lr": 1e-2, "batch_size": 32, "epochs": 3}, 16, seed=0)
    rbm.fit(data, verbose=0)
    torch.cuda.synchronize()
    assert cd_gibbs.cd_train_cuda.launches == before + 1
    assert rbm.last_scores.shape == (3 * 10,)
    assert torch.isfinite(rbm.last_scores).all()
    assert rbm.params["rbm_weight"].device.type == "cuda"


# ---------------------------------------------------------------------------
# The serving kernels: flash forward and flash decoding against their plain
# versions. f32 rtol/atol 1e-4 (sums in another order); bf16 rtol 1e-2, just
# above one bf16 ulp (2^-7 of the value: the output's own rounding can fall
# either way), atol 2e-3 (the probabilities round to bf16 against another
# running max, 2^-9 of each term); the f32 LSE 1e-4 in both. The flash
# kernels run bf16 up to 128 wide on the tensor cores and the rest on the
# CUDA cores: each case checks its launch's route and layout, as the C
# entry reports them, against the wrapper's plan, and its copies.
# ---------------------------------------------------------------------------

from ku_torch.kernels import decode_attention as da  # noqa: E402
from ku_torch.kernels import flash_attention as fa  # noqa: E402
from ku_torch.nn import Transformer, generate  # noqa: E402

SERVE_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
             torch.bfloat16: dict(rtol=1e-2, atol=2e-3)}
FLASH_CASES = {
    "gqa_window_softcap_rows": dict(b=2, h=4, hkv=2, n=37, kn=53, d=64, window=7,
                                    softcap=1.5, q_offset=[16, 3]),
    "mqa_segments_scalar": dict(b=2, h=4, hkv=1, n=70, kn=70, d=32,
                                segments=True, q_offset=3, k_offset=1),
    "noncausal_long_keys": dict(b=1, h=3, hkv=3, n=5, kn=130, d=128, causal=False),
    "cache_view_rows": dict(b=3, h=8, hkv=2, n=65, kn=200, d=128, cache_view=True,
                            q_offset=[0, 64, 100]),
    # Widths the tensor-core tiles zero-fill; layouts the wrapper copies for
    # the tensor cores (a cache 203 slots wide, q strided or 2 bytes off
    # 16); a bf16 head wider than 128 (the CUDA-core kernel, by shape).
    "d40_dv24": dict(b=2, h=4, hkv=2, n=70, kn=90, d=40, dv=24, window=30),
    "d36_dv12": dict(b=1, h=2, hkv=2, n=64, kn=128, d=36, dv=12),
    "cache_view_width_203": dict(b=2, h=4, hkv=2, n=33, kn=203, d=128, cache_view=True,
                                 q_offset=[0, 150]),
    "q_strided": dict(b=1, h=4, hkv=2, n=65, kn=65, d=64, q_layout="strided"),
    "q_offset_2_bytes": dict(b=1, h=2, hkv=1, n=40, kn=70, d=64, q_layout="offset",
                             softcap=5.0),
    "d160": dict(b=1, h=2, hkv=1, n=50, kn=70, d=160, dv=128),
    # Odd widths and an odd count of keys read in place from a wider cache:
    # the 16-byte copies' last chunk of a row or key run is partial.
    "d37_dv21": dict(b=2, h=4, hkv=2, n=45, kn=77, d=37, dv=21, window=40),
    "cache_view_203_of_208": dict(b=2, h=4, hkv=2, n=33, kn=203, d=64, cache_view=True,
                                  cache_slots=208, q_offset=[0, 150]),
    # Causal with no segments, window or ragged edge, rows along D: the key
    # tiles below the diagonal are full and test no pair.
    "causal_full_tiles": dict(b=2, h=4, hkv=2, n=256, kn=256, d=128),
}


def _q_in_layout(q, layout):
    """q's values in a layout the tensor-core kernels cannot read as it is:
    "strided", every other element of rows twice as wide; "offset", one
    element into a flat buffer (2 bytes off 16 in bf16)."""
    if layout == "strided":
        wide = torch.zeros(*q.shape[:-1], 2 * q.shape[-1], dtype=q.dtype, device=q.device)
        wide[..., ::2] = q
        return wide[..., ::2]
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=q.device)
    out = flat[1:].view(q.shape)
    out.copy_(q)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_fwd_matches_plain(device, case, dtype):
    c = dict(FLASH_CASES[case])
    b, h, hkv, n, kn, d = (c.pop(k) for k in ("b", "h", "hkv", "n", "kn", "d"))
    dv = c.pop("dv", d)
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(b, h, n, d, generator=g, device=device).to(dtype)
    if "q_layout" in c:
        q = _q_in_layout(q, c.pop("q_layout"))
    if c.pop("cache_view", False):
        slots = c.pop("cache_slots", kn)
        k, v = (torch.randn(b, hkv, w, slots, generator=g, device=device).to(dtype)
                [..., :kn].transpose(2, 3) for w in (d, dv))
    else:
        k, v = (torch.randn(b, hkv, kn, w, generator=g, device=device).to(dtype)
                for w in (d, dv))
    seg = None
    if c.pop("segments", False):
        seg = torch.sort(torch.randint(0, 4, (b, n), generator=g, device=device),
                         dim=1).values.to(torch.int32)
    offsets = {key: torch.tensor(c.pop(key), dtype=torch.int32, device=device)
               if isinstance(c.get(key), list) else c.pop(key)
               for key in ("q_offset", "k_offset") if key in c}
    kw = dict(softmax_scale=0.1, causal=c.pop("causal", True),
              window=c.pop("window", None), logit_softcap=c.pop("softcap", None),
              segment_ids=seg, **offsets)
    route = fa.flash_route(dtype, d)
    layout = fa.flash_layout(q, k, v) if route == "mma" else None
    before, copies = fa.flash_fwd_cuda.launches, fa.flash_fwd_cuda.copies
    o_k, lse_k = fa.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_fwd_cuda.launches == before + 1
    assert (fa.flash_fwd_cuda.route, fa.flash_fwd_cuda.layout) == (route, layout)
    assert route == ("f32" if dtype == torch.float32 or d > 128 else "mma")
    assert (fa.flash_fwd_cuda.copies > copies) == (layout == "c")
    if case == "cache_view_rows" and dtype == torch.bfloat16:
        assert layout == "b" and fa.flash_fwd_cuda.copies == copies  # read in place
    if case == "cache_view_width_203" and dtype == torch.bfloat16:
        assert layout == "c" and fa.flash_fwd_cuda.copies == copies + 2
    if case == "cache_view_203_of_208" and dtype == torch.bfloat16:
        assert layout == "b" and fa.flash_fwd_cuda.copies == copies
    if case == "causal_full_tiles" and dtype == torch.bfloat16:
        assert layout == "a" and fa.flash_fwd_cuda.copies == copies
    o_p, lse_p = fa.flash_fwd_torch(q, k, v, **kw)
    torch.testing.assert_close(o_k, o_p, **SERVE_TOL[dtype])
    torch.testing.assert_close(lse_k, lse_p, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(b=3, hkv=2, g=1, d=64, s=300, lengths=[1, 300, 129], softcap=2.0),
    dict(b=2, hkv=2, g=4, d=128, s=1024, lengths=[1024, 77], softcap=None),
    dict(b=2, hkv=1, g=16, d=80, s=77, lengths=[77, 5], softcap=None, int8=True),
])
def test_decode_attention_matches_plain(device, case, dtype):
    g = torch.Generator(device=device).manual_seed(1)
    b, hkv, g_, d, s = case["b"], case["hkv"], case["g"], case["d"], case["s"]
    q = torch.randn(b, hkv, g_, d, generator=g, device=device).to(dtype)
    kw = dict(softmax_scale=0.05, logit_softcap=case["softcap"])
    if case.get("int8"):
        k, v = (torch.randint(-127, 128, (b, hkv, d, s), generator=g,
                              device=device).to(torch.int8) for _ in range(2))
        kw["k_scale"], kw["v_scale"] = (
            torch.rand(b, hkv, s, generator=g, device=device) * 0.02 for _ in range(2))
    else:
        k, v = (torch.randn(b, hkv, d, s, generator=g, device=device).to(dtype)
                for _ in range(2))
    lengths = torch.tensor(case["lengths"], dtype=torch.int32, device=device)
    before = da.decode_attention_cuda.launches
    o_k = da.decode_attention(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    assert da.decode_attention_cuda.launches == before + 1
    torch.testing.assert_close(o_k, da.decode_attention_torch(q, k, v, lengths, **kw),
                               **SERVE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_with_no_live_key_are_zero_on_the_card(device, dtype):
    # Flash: keys start at global position 10, so causal rows 0..9 of row 0
    # see none within a visited tile, and row 1 (queries at -80..-11) visits
    # no tile at all. Decode: lengths 0 and -1.
    g = torch.Generator(device=device).manual_seed(2)
    q, k, v = (torch.randn(2, 2, 70, 32, generator=g, device=device).to(dtype)
               for _ in range(3))
    kw = dict(causal=True, k_offset=10, softmax_scale=0.1,
              q_offset=torch.tensor([0, -80], dtype=torch.int32, device=device))
    o, lse = fa.flash_fwd_cuda(q, k[:, :1], v[:, :1], **kw)
    o_p, lse_p = fa.flash_fwd_torch(q, k[:, :1], v[:, :1], **kw)
    assert torch.all(o[0, :, :10] == 0) and torch.all(o[1] == 0)
    assert torch.all(lse[0, :, :10] == -1e30) and torch.all(lse[1] == -1e30)
    torch.testing.assert_close(o, o_p, **SERVE_TOL[dtype])
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)
    qd = torch.randn(3, 2, 4, 64, generator=g, device=device).to(dtype)
    cache = [torch.randn(3, 2, 64, 130, generator=g, device=device).to(dtype)
             for _ in range(2)]
    lengths = torch.tensor([0, 130, -1], dtype=torch.int32, device=device)
    out = da.decode_attention_cuda(qd, *cache, lengths)
    assert torch.all(out[0] == 0) and torch.all(out[2] == 0)
    torch.testing.assert_close(out, da.decode_attention_torch(qd, *cache, lengths),
                               **SERVE_TOL[dtype])


def test_serving_wrappers_reject_what_the_kernels_do_not_take(device):
    q = torch.zeros(1, 2, 4, 16, device=device)
    with pytest.raises(ValueError, match="float32 or all"):
        fa.flash_fwd_cuda(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_fwd_cuda(q, q.cpu(), q)
    wide = torch.zeros(1, 2, 4, 160, device=device)
    with pytest.raises(ValueError, match="up to 128"):
        fa.flash_fwd_cuda(wide, wide, wide)
    qd = torch.zeros(1, 1, 2, 16, device=device)
    cache = torch.zeros(1, 1, 16, 8, device=device)
    lengths = torch.ones(1, dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention_cuda(qd, cache, cache, lengths.long())
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention_cuda(qd, cache.transpose(2, 3).contiguous().transpose(2, 3),
                                 cache, lengths)
    with pytest.raises(ValueError, match="CUDA tensors"):
        da.decode_attention_cuda(qd, cache.cpu(), cache, lengths)
    with pytest.raises(ValueError, match="dtype"):
        da.decode_attention_cuda(qd, cache.bfloat16(), cache.bfloat16(), lengths)
    with pytest.raises(ValueError, match="up to 16"):
        da.decode_attention_cuda(torch.zeros(1, 1, 17, 16, device=device), cache,
                                 cache, lengths)


def test_generate_on_the_card_goes_through_both_kernels(device):
    """A tiny f32 LM: generate through the kernels emits the ids of the
    plain paths (use_flash=False, flash_decode=False)."""
    torch.manual_seed(0)
    gen = torch.Generator(device=device).manual_seed(0)
    kw = dict(causal=True, rope=True, num_kv_head=2, max_decode_len=64,
              device=device, generator=gen)
    fast = Transformer(4, 32, use_flash=True, **kw)
    plain = Transformer(4, 32, use_flash=False, flash_decode=False, **kw)
    plain.load_state_dict(fast.state_dict())
    table = torch.randn(50, 32, device=device)
    prompts = torch.randint(0, 50, (3, 9), device=device)
    lens = torch.tensor([9, 4, 6], dtype=torch.int32, device=device)
    io = dict(embed=lambda i, p=None: table[i], readout=lambda y: y @ table.T,
              prompt_lengths=lens, return_logprobs=True)
    f0, d0 = fa.flash_fwd_cuda.launches, da.decode_attention_cuda.launches
    ids, lps = generate(fast, prompts, 12, **io)
    torch.cuda.synchronize()
    assert fa.flash_fwd_cuda.launches - f0 == 2
    assert da.decode_attention_cuda.launches - d0 == 2 * 11
    ids_p, lps_p = generate(plain, prompts, 12, **io)
    assert torch.equal(ids, ids_p)
    torch.testing.assert_close(lps, lps_p, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Paged flash decoding (kernel #7) against its plain version: permuted
# tables whose dead tails point at a NaN-poisoned page, a length past the
# table's end, pages that are not a multiple of 32 slots; f32, bf16, int8.
# ---------------------------------------------------------------------------

from ku_torch.nn import ContinuousBatcher  # noqa: E402


def _paged_inputs(device, dtype, b, hkv, g_, d, pg, mp, lengths, int8, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    n_pool = b * mp + 1
    order = torch.randperm(n_pool, generator=gen, device=device)
    poison, table = order[-1], order[:-1].view(b, mp).to(torch.int32)
    for row, n in enumerate(lengths):
        table[row, max(0, -(-n // pg)):] = poison
    q = torch.randn(b, hkv, g_, d, generator=gen, device=device).to(dtype)
    kw = {}
    if int8:
        k, v = (torch.randint(-127, 128, (n_pool, hkv, d, pg), generator=gen,
                              device=device).to(torch.int8) for _ in range(2))
        kw["k_scale"], kw["v_scale"] = (
            torch.rand(n_pool, hkv, pg, generator=gen, device=device) * 0.02
            for _ in range(2))
        kw["k_scale"][poison] = kw["v_scale"][poison] = float("nan")
    else:
        k, v = (torch.randn(n_pool, hkv, d, pg, generator=gen, device=device).to(dtype)
                for _ in range(2))
        k[poison] = v[poison] = float("nan")
    lengths = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, k, v, table, lengths, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(b=3, hkv=2, g=4, d=128, pg=16, mp=8, lengths=[1, 16, 200], softcap=None),
    dict(b=2, hkv=2, g=1, d=64, pg=256, mp=3, lengths=[300, 1], softcap=2.0),
    dict(b=3, hkv=1, g=16, d=80, pg=7, mp=5, lengths=[35, 0, 13], softcap=None,
         int8=True),
])
def test_paged_decode_attention_matches_plain(device, case, dtype):
    c = case
    q, k, v, table, lengths, kw = _paged_inputs(
        device, dtype, c["b"], c["hkv"], c["g"], c["d"], c["pg"], c["mp"],
        c["lengths"], c.get("int8", False), seed=3)
    kw.update(softmax_scale=0.05, logit_softcap=c["softcap"])
    before = da.decode_attention_paged_cuda.launches
    out = da.decode_attention_paged(q, k, v, table, lengths, **kw)
    torch.cuda.synchronize()
    assert da.decode_attention_paged_cuda.launches == before + 1
    assert da.last_launch()["route"] == ("element" if c["pg"] == 7 else "16-byte")
    assert torch.isfinite(out).all()
    torch.testing.assert_close(
        out, da.decode_attention_paged_torch(q, k, v, table, lengths, **kw),
        **SERVE_TOL[dtype])


def test_paged_decode_attention_overrun_reads_the_whole_window(device):
    q, k, v, table, _, _ = _paged_inputs(device, torch.float32, 2, 2, 4, 32, 8, 3,
                                         [24, 24], False, seed=4)
    full = torch.full((2,), 24, dtype=torch.int32, device=device)
    over = torch.tensor([25, 1000], dtype=torch.int32, device=device)
    torch.testing.assert_close(da.decode_attention_paged_cuda(q, k, v, table, over),
                               da.decode_attention_paged_cuda(q, k, v, table, full),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype, s", [(torch.float32, 300), (torch.bfloat16, 300),
                                      (torch.float32, 1024), (torch.bfloat16, 1024)])
def test_paged_decode_attention_identity_table_is_the_dense_kernel(device, dtype, s):
    """One page as wide as the cache, through an identity table, is the
    dense read of the same slots, bit for bit: both fold the chunks of
    split_plan in the same order. bf16 at S 300 takes the element loads,
    the rest the 16-byte copies (a segment holds 4 f32 or 8 bf16 slots)."""
    gen = torch.Generator(device=device).manual_seed(5)
    q = torch.randn(3, 2, 4, 64, generator=gen, device=device).to(dtype)
    k, v = (torch.randn(3, 2, 64, s, generator=gen, device=device).to(dtype)
            for _ in range(2))
    lengths = torch.tensor([s, 129, 1], dtype=torch.int32, device=device)
    table = torch.arange(3, dtype=torch.int32, device=device)[:, None]
    o_p = da.decode_attention_paged_cuda(q, k, v, table, lengths)
    launched_p = da.last_launch()
    o_d = da.decode_attention_cuda(q, k, v, lengths)
    torch.cuda.synchronize()
    assert launched_p == da.last_launch()
    assert launched_p["route"] == da.copy_route(k, v) == (
        "element" if (dtype, s) == (torch.bfloat16, 300) else "16-byte")
    assert torch.equal(o_p, o_d)


def test_paged_wrapper_rejects_what_the_kernel_does_not_take(device):
    q, k, v, table, lengths, _ = _paged_inputs(device, torch.float32, 2, 1, 2, 16,
                                               4, 3, [5, 9], False, seed=6)
    with pytest.raises(ValueError, match="page_table must be int32"):
        da.decode_attention_paged_cuda(q, k, v, table.long(), lengths)
    with pytest.raises(ValueError, match="CUDA tensors"):
        da.decode_attention_paged_cuda(q, k, v, table.cpu(), lengths)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention_paged_cuda(q, k, v, table.t().contiguous().t(), lengths)
    with pytest.raises(ValueError, match="up to 16"):
        da.decode_attention_paged_cuda(q.repeat(1, 1, 9, 1), k, v, table, lengths)
    with pytest.raises(ValueError, match="int8 caches"):
        da.decode_attention_paged_cuda(q, k.to(torch.int8), v.to(torch.int8),
                                       table, lengths)


def _tiny_lm(device, **kw):
    gen = torch.Generator(device=device).manual_seed(0)
    return Transformer(4, 32, causal=True, rope=True, num_kv_head=2,
                       max_decode_len=64, device=device, generator=gen, **kw)


@pytest.mark.parametrize("cache_kw", [dict(kv_page_size=16),
                                      dict(kv_page_size=16, kv_cache_dtype="int8")])
def test_paged_generate_on_the_card_goes_through_the_paged_kernel(device, cache_kw):
    """Paged generate launches the flash kernel for the prefill and the
    paged decode kernel (never the dense one) for every step, and emits
    the ids of its plain paths."""
    fast = _tiny_lm(device, use_flash=True, **cache_kw)
    plain = _tiny_lm(device, use_flash=False, flash_decode=False, **cache_kw)
    plain.load_state_dict(fast.state_dict())
    table = torch.randn(50, 32, generator=torch.Generator(device=device).manual_seed(1),
                        device=device)
    prompts = torch.randint(0, 50, (3, 9), device=device)
    lens = torch.tensor([9, 4, 6], dtype=torch.int32, device=device)
    io = dict(embed=lambda i, p=None: table[i], readout=lambda y: y @ table.T,
              prompt_lengths=lens)
    f0, d0 = fa.flash_fwd_cuda.launches, da.decode_attention_cuda.launches
    p0 = da.decode_attention_paged_cuda.launches
    ids = generate(fast, prompts, 12, **io)
    torch.cuda.synchronize()
    assert fa.flash_fwd_cuda.launches - f0 == 2
    assert da.decode_attention_paged_cuda.launches - p0 == 2 * 11
    assert da.decode_attention_cuda.launches == d0
    assert torch.equal(ids, generate(plain, prompts, 12, **io))


def test_reallocated_page_is_never_written_by_its_former_row_on_the_card(device):
    """The batcher's hazard on the card: a finished row points at scratch
    before the next decode chunk, so its freed pages stay as they were until
    a new request is admitted into them, and that request emits what it
    emits alone."""
    model = _tiny_lm(device, use_flash=True, kv_page_size=4, kv_num_pages=7)
    table = torch.randn(50, 32, generator=torch.Generator(device=device).manual_seed(2),
                        device=device)
    io = dict(embed=lambda i, p=None: table[i], readout=lambda y: y @ table.T)
    cb = ContinuousBatcher(model, num_slots=2, prompt_len=4, chunk=2,
                           max_decode_len=64, **io)
    cb.reset()
    rng = np.random.default_rng(5)
    a, c, b = (rng.integers(0, 50, size=(n,)) for n in (3, 4, 2))
    cb.submit(a, 4)
    cb.submit(c, 12)
    assert cb.step() == {}
    pages_a = list(cb._slot_pages[0])
    assert list(cb.step()) == [0]
    assert torch.all(cb._table[0] == 0)
    before = {k: t[pages_a].clone() for k, t in cb._cache.items()
              if k.endswith(("pages_k", "pages_v"))}
    p0 = da.decode_attention_paged_cuda.launches
    assert cb.step() == {}
    torch.cuda.synchronize()
    assert da.decode_attention_paged_cuda.launches - p0 == 2 * 2
    for k, t in before.items():
        assert torch.equal(cb._cache[k][pages_a], t), k
    cb.submit(b, 4)
    out = cb.step()
    assert sorted(cb._slot_pages[0]) == sorted(pages_a)
    while not cb.idle:
        out.update(cb.step())
    alone = generate(_tiny_lm(device, use_flash=True, kv_page_size=4),
                     torch.from_numpy(b).to(device)[None], 4, **io)
    np.testing.assert_array_equal(out[2], alone[0].cpu().numpy())


# ---------------------------------------------------------------------------
# Split-K over a cluster (kernels #6 and #7): lengths at every edge of the
# kernel's chunk plan (da.split_plan), both copy routes as the C entry
# reports them, the plan itself as the C entry computes it, and the two
# bit-for-bit invariants (a row alone and in a batch).
# ---------------------------------------------------------------------------

SPLIT_EDGES = [0, -1, 1, 63, 64, 65, 511, 512, 513]


def _dense_inputs(device, dtype, b, hkv, g_, d, dv, s, int8, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, hkv, g_, d, generator=gen, device=device).to(dtype)
    kw = {}
    if int8:
        k, v = (torch.randint(-127, 128, (b, hkv, w, s), generator=gen,
                              device=device).to(torch.int8) for w in (d, dv))
        kw["k_scale"], kw["v_scale"] = (
            torch.rand(b, hkv, s, generator=gen, device=device) * 0.02 for _ in range(2))
    else:
        k, v = (torch.randn(b, hkv, w, s, generator=gen, device=device).to(dtype)
                for w in (d, dv))
    return q, k, v, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(g=4, d=128, dv=128, s=1024),
    dict(g=1, d=64, dv=64, s=1024),
    dict(g=16, d=64, dv=32, s=1024),
    dict(g=4, d=128, dv=96, s=1024, int8=True, softcap=2.0),
    # The element loads: S not a multiple of a 16-byte segment's slots.
    dict(g=4, d=64, dv=48, s=77),
    dict(g=16, d=32, dv=32, s=130, int8=True, softcap=2.0),
])
def test_decode_split_edges_match_plain(device, case, dtype):
    c = case
    lengths = SPLIT_EDGES + [c["s"], c["s"] + 100]
    q, k, v, kw = _dense_inputs(device, dtype, len(lengths), 2, c["g"], c["d"], c["dv"],
                                c["s"], c.get("int8", False), seed=7)
    kw.update(softmax_scale=0.05, logit_softcap=c.get("softcap"))
    lengths = torch.tensor(lengths, dtype=torch.int32, device=device)
    out = da.decode_attention_cuda(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    launched = da.last_launch()
    assert launched["s_split"] == da.S_SPLIT
    assert launched["route"] == da.copy_route(k, v, kw.get("k_scale"), kw.get("v_scale"))
    assert launched["route"] == ("16-byte" if c["s"] == 1024 else "element")
    assert launched["fold"] == da.fold_route(q, k, v) == (
        "mma" if dtype == torch.bfloat16 and c["g"] <= 4 and not c.get("int8") else "fma")
    assert torch.isfinite(out).all()
    assert torch.all(out[:2] == 0)  # lengths 0 and -1
    torch.testing.assert_close(out, da.decode_attention_torch(q, k, v, lengths, **kw),
                               **SERVE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(g=4, d=128, pg=16, mp=36),
    dict(g=1, d=64, pg=64, mp=9),
    dict(g=16, d=64, pg=256, mp=3, int8=True, softcap=2.0),
])
def test_paged_split_edges_match_plain(device, case, dtype):
    """Permuted tables whose dead entries name a NaN-poisoned page: no block
    reads one, not even a block with an empty chunk."""
    c = case
    lengths = SPLIT_EDGES + [c["pg"] * c["mp"], c["pg"] * c["mp"] + 100]
    q, k, v, table, lengths, kw = _paged_inputs(
        device, dtype, len(lengths), 2, c["g"], c["d"], c["pg"], c["mp"], lengths,
        c.get("int8", False), seed=8)
    kw.update(softmax_scale=0.05, logit_softcap=c.get("softcap"))
    out = da.decode_attention_paged_cuda(q, k, v, table, lengths, **kw)
    torch.cuda.synchronize()
    launched = da.last_launch()
    assert launched["route"] == da.copy_route(k, v, kw.get("k_scale"), kw.get("v_scale"))
    assert launched["route"] == "16-byte" and launched["s_split"] == da.S_SPLIT
    assert launched["fold"] == da.fold_route(q, k, v)
    assert torch.isfinite(out).all()
    assert torch.all(out[:2] == 0)
    torch.testing.assert_close(
        out, da.decode_attention_paged_torch(q, k, v, table, lengths, **kw),
        **SERVE_TOL[dtype])


def test_the_path_shape_takes_the_cluster_split_16_byte_route(device):
    """bf16, B 8, Hkv 4, G 4, D 128: the dense 1,024-slot cache and 256-slot
    pages take the 16-byte copies and the tensor cores, 8 blocks a cluster,
    at a number of stages at which the card holds all 32 clusters at
    once."""
    q, k, v, _ = _dense_inputs(device, torch.bfloat16, 8, 4, 4, 128, 128, 1024, False, 9)
    lengths = torch.tensor([192, 200, 210, 220, 230, 240, 250, 256], dtype=torch.int32,
                           device=device)
    da.decode_attention_cuda(q, k, v, lengths)
    launched = da.last_launch()
    assert launched["route"] == "16-byte" and launched["s_split"] == 8
    assert launched["fold"] == "mma"
    assert 2 <= launched["stages"] <= 4 and launched["clusters"] >= 32
    pool_k, pool_v = (x.view(8, 4, 128, 4, 256).permute(0, 3, 1, 2, 4).reshape(32, 4, 128, 256)
                      for x in (k, v))
    table = torch.arange(32, dtype=torch.int32, device=device).view(8, 4)
    da.decode_attention_paged_cuda(q, pool_k, pool_v, table, lengths)
    torch.cuda.synchronize()
    assert da.last_launch() == launched


def test_c_entry_split_chunk_is_split_plan(device):
    lib = da._library()
    for n in list(range(-2, 1200)) + [2047, 2048, 2049, 65536, 100003]:
        c = lib.decode_attention_split_chunk(n)
        assert c == da.split_chunk(n), n
        plan = da.split_plan(n)
        assert all(hi - lo == c for lo, hi in plan if hi < max(n, 0)), n


@pytest.mark.parametrize("paged", [False, True])
def test_a_row_reads_alike_alone_and_in_a_batch(device, paged):
    """A row's output depends on its own length and slots only: row i of a
    batch of 8 equals the same row read at B = 1, bit for bit."""
    q, k, v, _ = _dense_inputs(device, torch.bfloat16, 8, 4, 4, 128, 128, 1024, False, 10)
    lengths = torch.tensor([1, 64, 200, 511, 513, 700, 1000, 1024], dtype=torch.int32,
                           device=device)
    if paged:
        pool_k, pool_v = (x.view(8, 4, 128, 4, 256).permute(0, 3, 1, 2, 4)
                          .reshape(32, 4, 128, 256) for x in (k, v))
        perm = torch.randperm(32, generator=torch.Generator(device=device).manual_seed(3),
                              device=device)
        table = torch.argsort(perm).to(torch.int32).view(8, 4)
        pool_k, pool_v = pool_k[perm].contiguous(), pool_v[perm].contiguous()
        read = lambda i: da.decode_attention_paged_cuda(  # noqa: E731
            q[i], pool_k, pool_v, table[i], lengths[i])
    else:
        read = lambda i: da.decode_attention_cuda(q[i], k[i], v[i], lengths[i])  # noqa: E731
    batch = read(slice(None))
    for i in range(8):
        assert torch.equal(read(slice(i, i + 1)), batch[i:i + 1]), i


# ---------------------------------------------------------------------------
# The flash backward kernels (dq, dk/dv) against their plain versions, on the
# same o, lse and delta; and a Trainer step through all three flash kernels.
# f32 rtol/atol 1e-4 (sums in another order); bf16 rtol 2e-2 and atol 1e-2
# of each gradient's largest entry (p and ds are rounded to bf16 before
# their products, and an f32 ulp in a score can move one of those
# roundings, 2^-8 of the value).
# ---------------------------------------------------------------------------

from ku_torch.engine_ext import Trainer  # noqa: E402

BWD_CASES = {
    "gqa_window_softcap_rows": dict(b=2, h=4, hkv=2, n=37, kn=53, d=64, window=7,
                                    softcap=1.5, q_offset=[16, 3]),
    "mqa_segments_scalar": dict(b=2, h=4, hkv=1, n=70, kn=70, d=32, segments=True,
                                q_offset=3, k_offset=1),
    "noncausal_long_keys": dict(b=1, h=3, hkv=3, n=5, kn=130, d=128, causal=False),
    "gqa_d128_strided_do": dict(b=2, h=8, hkv=2, n=130, kn=130, d=128,
                                strided_do=True),
    "dead_rows": dict(b=2, h=2, hkv=1, n=70, kn=70, d=32, k_offset=10,
                      q_offset=[0, -80]),
    "value_heads_narrower": dict(b=2, h=4, hkv=2, n=50, kn=61, d=128, dv=64),
    "value_heads_wider": dict(b=1, h=2, hkv=1, n=65, kn=65, d=32, dv=96, window=20),
    # Widths the tensor-core tiles zero-fill; q in layouts the wrapper
    # copies for the tensor cores.
    "d40_dv24": dict(b=2, h=4, hkv=2, n=70, kn=90, d=40, dv=24, window=30),
    "d36_dv12": dict(b=1, h=2, hkv=2, n=64, kn=128, d=36, dv=12, strided_do=True),
    "q_strided": dict(b=1, h=4, hkv=2, n=65, kn=65, d=64, q_layout="strided"),
    "q_offset_2_bytes": dict(b=1, h=2, hkv=1, n=40, kn=70, d=64, q_layout="offset",
                             softcap=5.0),
    "d37_dv21": dict(b=2, h=4, hkv=2, n=45, kn=77, d=37, dv=21, window=40, softcap=3.0),
    # Causal with no segments, window or ragged edge: full tiles, no pair tested.
    "causal_full_tiles": dict(b=2, h=4, hkv=2, n=256, kn=256, d=128, strided_do=True),
}


def _bwd_close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=1e-2 * float(want.float().abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_kernels_match_plain(device, case, dtype):
    c = dict(BWD_CASES[case])
    b, h, hkv, n, kn, d = (c.pop(k) for k in ("b", "h", "hkv", "n", "kn", "d"))
    dv = c.pop("dv", d)
    g = torch.Generator(device=device).manual_seed(3)
    q = torch.randn(b, h, n, d, generator=g, device=device).to(dtype)
    if "q_layout" in c:
        q = _q_in_layout(q, c.pop("q_layout"))
    k = torch.randn(b, hkv, kn, d, generator=g, device=device).to(dtype)
    v = torch.randn(b, hkv, kn, dv, generator=g, device=device).to(dtype)
    if c.pop("strided_do", False):
        do = torch.randn(b, n, h, dv, generator=g, device=device).to(dtype).transpose(1, 2)
    else:
        do = torch.randn(b, h, n, dv, generator=g, device=device).to(dtype)
    seg = None
    if c.pop("segments", False):
        seg = torch.sort(torch.randint(0, 4, (b, n), generator=g, device=device),
                         dim=1).values.to(torch.int32)
    offsets = {key: torch.tensor(c.pop(key), dtype=torch.int32, device=device)
               if isinstance(c.get(key), list) else c.pop(key)
               for key in ("q_offset", "k_offset") if key in c}
    kw = dict(softmax_scale=0.1, causal=c.pop("causal", True),
              window=c.pop("window", None), logit_softcap=c.pop("softcap", None),
              segment_ids=seg, **offsets)
    o, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    before = (fa.flash_bwd_dq_cuda.launches, fa.flash_bwd_dkv_cuda.launches)
    copies = (fa.flash_bwd_dq_cuda.copies, fa.flash_bwd_dkv_cuda.copies)
    dq, dk, dv_ = fa.flash_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq_cuda.launches, fa.flash_bwd_dkv_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    route = "mma" if dtype == torch.bfloat16 else "f32"
    assert (fa.flash_bwd_dq_cuda.route, fa.flash_bwd_dkv_cuda.route) == (route, route)
    copied = sum(not fa._mma_ready(t) for t in (q, k, v, do)) if route == "mma" else 0
    assert (fa.flash_bwd_dq_cuda.copies, fa.flash_bwd_dkv_cuda.copies) == (
        copies[0] + copied, copies[1] + copied)
    assert dq.shape == q.shape and dk.shape == k.shape and dv_.shape == v.shape
    _bwd_close(dq, fa.flash_bwd_dq_torch(q, k, v, do, lse, delta, **kw), dtype)
    dk_p, dv_p = fa.flash_bwd_dkv_torch(q, k, v, do, lse, delta, **kw)
    _bwd_close(dk, dk_p, dtype)
    _bwd_close(dv_, dv_p, dtype)
    dead = lse == -1e30
    assert torch.all(dq[dead] == 0)
    if case == "dead_rows":
        assert dead[1].all() and torch.all(dk[1] == 0) and torch.all(dv_[1] == 0)


def test_flash_bwd_wrappers_reject_what_the_kernels_do_not_take(device):
    q = torch.zeros(1, 2, 4, 16, device=device)
    lse = torch.zeros(1, 2, 4, device=device)
    with pytest.raises(ValueError, match="float32 or all"):
        fa.flash_bwd_dq_cuda(q, q, q, q.bfloat16(), lse, lse)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_bwd_dkv_cuda(q, q, q, q.cpu(), lse, lse)
    with pytest.raises(ValueError, match="float32 on"):
        fa.flash_bwd_dkv_cuda(q, q, q, q, lse, lse.cpu())
    with pytest.raises(ValueError, match="float32 on"):
        fa.flash_bwd_dq_cuda(q, q, q, q, lse, lse.double())
    wide = torch.zeros(1, 2, 4, 160, device=device)
    with pytest.raises(ValueError, match="up to 128"):
        fa.flash_bwd_dkv_cuda(wide, wide, wide, wide, lse, lse)


def test_flash_mma_launch_refuses_rows_it_cannot_read(device, monkeypatch):
    """The wrapper copies a bf16 tensor that the tensor-core kernels cannot
    read (layout "c"); without that copy the C entries refuse the launch,
    and the wrappers raise: nothing falls back to the CUDA-core kernels."""
    q = _q_in_layout(torch.randn(1, 2, 64, 16, device=device).bfloat16(), "offset")
    k = torch.randn(1, 2, 64, 16, device=device).bfloat16()
    monkeypatch.setattr(fa, "_for_mma", lambda entry, *ts: ("c", ts))
    before = (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches)
    with pytest.raises(RuntimeError, match="misaligned"):
        fa.flash_fwd_cuda(q, k, k)
    lse = torch.zeros(1, 2, 64, device=device)
    with pytest.raises(RuntimeError, match="misaligned"):
        fa.flash_bwd_dq_cuda(q, k, k, k, lse, lse)
    assert (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches) == before


class _TiedLM(torch.nn.Module):
    """Two Transformer blocks between a tied embedding and readout."""

    def __init__(self, device, use_flash):
        super().__init__()
        gen = torch.Generator(device=device).manual_seed(0)
        self.embed = torch.nn.Embedding(50, 32, device=device)
        with torch.no_grad():
            self.embed.weight.copy_(torch.randn(50, 32, generator=gen, device=device))
        self.blocks = torch.nn.ModuleList(
            Transformer(4, 32, causal=True, rope=True, num_kv_head=2,
                        use_flash=use_flash, device=device, generator=gen)
            for _ in range(2))

    def forward(self, ids, deterministic=True):
        x = self.embed(ids)
        for block in self.blocks:
            x = block([x], deterministic=deterministic)
        return x @ self.embed.weight.T


def _xent(y_true, logits):
    return torch.nn.functional.cross_entropy(logits.transpose(1, 2), y_true,
                                             reduction="none").mean(-1)


def test_train_step_on_the_card_goes_through_the_flash_kernels(device):
    """Trainer.train_step on a small f32 LM launches the forward, dq and
    dk/dv kernels once per attention sublayer a step, and its first step's
    loss and gradients agree with those of the plain paths (use_flash=False)
    to 1e-4."""
    seqs = torch.randint(0, 50, (3, 70), device=device)
    x, y = seqs[:, :-1], seqs[:, 1:]
    fast, plain = _TiedLM(device, True), _TiedLM(device, False)
    plain.load_state_dict(fast.state_dict())
    counts = lambda: (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,  # noqa: E731
                      fa.flash_bwd_dkv_cuda.launches, da.decode_attention_cuda.launches)
    before = counts()
    tr = Trainer(fast, _xent)
    loss = tr.train_step(x, y)["loss"]
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [4, 4, 4, 0]
    loss_p = Trainer(plain, _xent).train_step(x, y)["loss"]
    assert [a - b for a, b in zip(counts(), before)] == [4, 4, 4, 0]
    assert abs(loss - loss_p) <= 1e-4 * abs(loss_p)
    for (name, p), q in zip(fast.named_parameters(), plain.parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-4, atol=1e-4, msg=name)
    assert torch.isfinite(torch.tensor(tr.train_step(x, y)["loss"]))
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [8, 8, 8, 0]


# ---------------------------------------------------------------------------
# The block-sparse kernels (forward, dq, dk/dv) against their plain versions
# on the same inputs (the backward on the forward kernel's o, lse and
# delta), with the tolerances above: the forward's of the serving kernels,
# the backward's of the flash backward. And a Trainer step under a block
# mask through all three.
# ---------------------------------------------------------------------------

from ku_torch.kernels import sparse_attention as sa  # noqa: E402


def _strided_pattern():
    pat = np.zeros((6, 6), bool)
    for i in range(6):
        pat[i, i] = pat[i, max(0, i - 2)] = pat[i, 0] = True
    return pat


def _cross_pattern():
    pat = np.zeros((2, 6), bool)
    pat[0, 0] = pat[0, 2] = pat[1, 1] = True
    return pat


# (make_block_mask arguments, B, H, Hkv, D, Dv, options)
SPARSE_CASES = {
    "causal_d64": (((96,), dict(block_q=16, block_k=16, causal=True)), 2, 2, 2, 64, 64, {}),
    "window_sinks_extra_mqa": (((96,), dict(block_q=16, block_k=16, causal=True, window=20,
                                            global_prefix=5, extra_blocks=((5, 1), (4, 0)))),
                               2, 4, 1, 64, 64, dict(strided_do=True)),
    "causal_pattern_narrow_values": (((96,), dict(block_q=16, block_k=16, causal=True,
                                                  block_pattern=_strided_pattern())),
                                     1, 4, 1, 64, 32, {}),
    "cross_poisoned": (((32, 96), dict(block_q=16, block_k=16,
                                       block_pattern=_cross_pattern())),
                       1, 2, 1, 128, 128, dict(poison=True)),
    "dead_rows": (((64, 32), dict(block_q=16, block_k=16, causal=True, window=24)),
                  1, 2, 1, 32, 32, {}),
    "nonsquare_blocks_gqa": (((512,), dict(block_q=128, block_k=64, causal=True, window=200,
                                           global_prefix=70)), 2, 8, 2, 128, 128,
                             dict(strided_do=True)),
    "blocks_512_wide_values": (((1024,), dict(block_q=512, block_k=512, causal=True,
                                              window=600, global_prefix=30)),
                               1, 4, 4, 64, 128, {}),
    # Widths that are not multiples of 16 (zero-filled to the tile's width
    # in shared memory), and q in layouts the tensor-core kernels cannot
    # copy as they are (a stride of 2 along D; a start 2 bytes off 16;
    # rows 72 bytes apart): the wrapper copies them first.
    "d40_dv24_gqa": (((96,), dict(block_q=16, block_k=16, causal=True, window=20,
                                  global_prefix=5)), 2, 4, 2, 40, 24, {}),
    "d40_dv24_blocks_128x64_strided_q": (((512,), dict(block_q=128, block_k=64, causal=True,
                                                       window=200, global_prefix=70)),
                                         1, 4, 2, 40, 24, dict(q_layout="strided")),
    "misaligned_q_blocks_64": (((256,), dict(block_q=64, block_k=64, causal=True, window=100,
                                             global_prefix=10)), 1, 2, 1, 64, 64,
                               dict(q_layout="offset", strided_do=True)),
    "odd_widths_d36_dv12": (((128,), dict(block_q=64, block_k=64, causal=True)),
                            1, 2, 2, 36, 12, {}),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_sparse_kernels_match_plain(device, case, dtype):
    (args, kw), b, h, hkv, d, dv, opts = SPARSE_CASES[case]
    mask = sa.make_block_mask(*args, **kw)
    g = torch.Generator(device=device).manual_seed(4)
    q = torch.randn(b, h, mask.n, d, generator=g, device=device).to(dtype)
    k = torch.randn(b, hkv, mask.kn, d, generator=g, device=device).to(dtype)
    v = torch.randn(b, hkv, mask.kn, dv, generator=g, device=device).to(dtype)
    unattended = torch.from_numpy(mask.qcnt == 0).to(device).repeat_interleave(mask.block_k)
    if opts.get("poison"):
        k[:, :, unattended] = float("nan")
        v[:, :, unattended] = float("nan")
    if opts.get("strided_do"):
        do = torch.randn(b, mask.n, h, dv, generator=g, device=device).to(dtype).transpose(1, 2)
    else:
        do = torch.randn(b, h, mask.n, dv, generator=g, device=device).to(dtype)
    if opts.get("q_layout"):
        q = _q_in_layout(q, opts["q_layout"])
        assert not sa._mma_ready(q)
    kernels = (sa.sparse_fwd_cuda, sa.sparse_bwd_dq_cuda, sa.sparse_bwd_dkv_cuda)
    before = tuple(f.launches for f in kernels)
    o, lse = sa.sparse_fwd(q, k, v, mask, 0.1)
    dq, dk, dv_ = sa.sparse_bwd(q, k, v, o, lse, do, mask, 0.1)
    torch.cuda.synchronize()
    assert tuple(f.launches for f in kernels) == tuple(x + 1 for x in before)
    route = "mma" if dtype == torch.bfloat16 else "f32"
    assert [f.route for f in kernels] == [route] * 3
    for t in (o, lse, dq, dk, dv_):
        assert torch.isfinite(t).all()
    o_p, lse_p = sa.sparse_fwd_torch(q, k, v, mask, 0.1)
    torch.testing.assert_close(o, o_p, **SERVE_TOL[dtype])
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)
    delta = (do.float() * o.float()).sum(-1)
    _bwd_close(dq, sa.sparse_bwd_dq_torch(q, k, v, do, lse, delta, mask, 0.1), dtype)
    dk_p, dv_p = sa.sparse_bwd_dkv_torch(q, k, v, do, lse, delta, mask, 0.1)
    _bwd_close(dk, dk_p, dtype)
    _bwd_close(dv_, dv_p, dtype)
    assert torch.all(dk[:, :, unattended] == 0) and torch.all(dv_[:, :, unattended] == 0)
    dead = lse == -1e30
    assert torch.all(o[dead] == 0) and torch.all(dq[dead] == 0)
    if case == "dead_rows":
        assert int(dead.sum()) == 2 * 9


def test_sparse_wrappers_reject_what_the_kernels_do_not_take(device):
    mask = sa.make_block_mask(32, block_q=16, block_k=16, causal=True)
    q = torch.zeros(1, 2, 32, 16, device=device)
    lse = torch.zeros(1, 2, 32, device=device)
    with pytest.raises(ValueError, match="float32 or all"):
        sa.sparse_fwd_cuda(q, q, q.bfloat16(), mask)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sa.sparse_bwd_dq_cuda(q, q, q, q.cpu(), lse, lse, mask)
    with pytest.raises(ValueError, match="float32 on"):
        sa.sparse_bwd_dkv_cuda(q, q, q, q, lse, lse.cpu(), mask)
    wide = torch.zeros(1, 2, 32, 160, device=device)
    with pytest.raises(ValueError, match="up to 128"):
        sa.sparse_bwd_dkv_cuda(wide, wide, wide, wide, lse, lse, mask)
    with pytest.raises(ValueError, match="do not match the BlockMask"):
        sa.sparse_fwd_cuda(q[:, :, :16], q, q, mask)


def test_sparse_mma_launch_refuses_rows_it_cannot_copy(device, monkeypatch):
    """The wrapper copies a bf16 tensor whose rows the tensor-core kernels
    cannot take; without that copy the C entry refuses the launch, and the
    wrapper raises: nothing falls back to the f32 kernels."""
    mask = sa.make_block_mask(64, block_q=16, block_k=16, causal=True)
    q = _q_in_layout(torch.randn(1, 2, 64, 16, device=device).bfloat16(), "offset")
    monkeypatch.setattr(sa, "_mma_rows", lambda t: t)
    before = sa.sparse_fwd_cuda.launches
    with pytest.raises(RuntimeError, match="misaligned"):
        sa.sparse_fwd_cuda(q, q.contiguous(), q.contiguous(), mask)
    assert sa.sparse_fwd_cuda.launches == before


class _SparseLM(_TiedLM):
    """_TiedLM's blocks called under a block mask."""

    def __init__(self, device, mask):
        super().__init__(device, use_flash=True)
        self.mask = mask

    def forward(self, ids, deterministic=True):
        x = self.embed(ids)
        for block in self.blocks:
            x = block([x], deterministic=deterministic, block_mask=self.mask)
        return x @ self.embed.weight.T


def test_train_step_under_a_block_mask_goes_through_the_sparse_kernels(device, monkeypatch):
    """Trainer.train_step on a small f32 LM under a window + sinks mask
    launches the sparse forward, dq and dk/dv kernels once per attention
    sublayer and no flash kernel; its loss and gradients agree with the same
    step through the plain versions to 1e-4."""
    mask = sa.make_block_mask(96, block_q=32, block_k=16, causal=True, window=40,
                              global_prefix=5)
    seqs = torch.randint(0, 50, (3, 97), device=device)
    x, y = seqs[:, :-1], seqs[:, 1:]
    fast = _SparseLM(device, mask)
    plain = _SparseLM(device, mask)
    plain.load_state_dict(fast.state_dict())
    kernels = (fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda,
               sa.sparse_fwd_cuda, sa.sparse_bwd_dq_cuda, sa.sparse_bwd_dkv_cuda)
    before = [f.launches for f in kernels]
    loss = Trainer(fast, _xent).train_step(x, y)["loss"]
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(kernels, before)] == [0, 0, 0, 4, 4, 4]
    monkeypatch.setattr(sa, "sparse_fwd", sa.sparse_fwd_torch)
    monkeypatch.setattr(sa, "sparse_bwd", sa.sparse_bwd_torch)
    loss_p = Trainer(plain, _xent).train_step(x, y)["loss"]
    assert [f.launches - b for f, b in zip(kernels, before)] == [0, 0, 0, 4, 4, 4]
    assert abs(loss - loss_p) <= 1e-4 * abs(loss_p)
    for (name, p), q in zip(fast.named_parameters(), plain.parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-4, atol=1e-4, msg=name)


# ---------------------------------------------------------------------------
# Data-parallel CD-k (kernel #2): the statistics and apply kernels against
# their plain versions, at world size 1 and at 4 ranks emulated in one
# process (their buffers summed in rank order), with kernel #1's tolerances
# above; world size 1 against kernel #1 bit for bit (the same device code,
# the same sums); RBM.fit(mesh=) in an NCCL world of one process.
# ---------------------------------------------------------------------------

import torch.distributed as dist  # noqa: E402

from ku_torch.dist import make_mesh  # noqa: E402
from ku_torch.ebm import DBN  # noqa: E402
from ku_torch.kernels import cd_gibbs_dp  # noqa: E402

DP_SHAPE = (37, 45, 40, 3)  # V, H, batch, steps: 10 rows a rank at W = 4


def _dp_compare(device, world, k, mode, saturated, epochs, p_tol, s_tol):
    v_dim, h_dim, batch, steps = DP_SHAPE
    params, v_all, mask = _problem(device, v_dim, h_dim, batch, steps, mode,
                                   saturated)
    args = (world, params, v_all, mask, 1234, 1e-3, k, mode, batch, epochs)
    p_k, s_k = cd_gibbs_dp.cd_train_dp_emulated(*args)
    torch.cuda.synchronize()
    p_p, s_p = cd_gibbs_dp.cd_train_dp_emulated(*args, plain=True)
    for name in NAMES:
        torch.testing.assert_close(p_k[name], p_p[name], rtol=p_tol[0],
                                   atol=p_tol[1], msg=name)
    torch.testing.assert_close(s_k, s_p, rtol=s_tol[0], atol=s_tol[1])
    assert torch.isfinite(s_k).all()


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("k", [1, 2])
def test_dp_kernels_match_plain_when_forced(device, k, world):
    _dp_compare(device, world, k, cd_gibbs.MODE_VISIBLE_BERNOULLI, True, 2,
                (1e-5, 1e-6), (1e-5, 1e-6))


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_dp_kernels_match_plain_with_shared_draws(device, mode, world):
    _dp_compare(device, world, 1, mode, False, 1, (1e-5, 1e-5), (1e-4, 1e-4))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_dp_kernels_at_world_one_equal_kernel_one(device, mode):
    v_dim, h_dim, batch, steps = DP_SHAPE
    params, v_all, mask = _problem(device, v_dim, h_dim, batch, steps, mode, False)
    args = (params, v_all, mask, 1234, 1e-3, 2, mode, batch, 2)
    p_dp, s_dp = cd_gibbs_dp.cd_train_dp_emulated(1, *args)
    p_1, s_1 = cd_gibbs.cd_train_cuda(*args)
    torch.cuda.synchronize()
    for name in NAMES:
        assert torch.equal(p_dp[name], p_1[name]), name
    assert torch.equal(s_dp, s_1)


@pytest.mark.parametrize("route", ["cluster", "global"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_dp_kernels_at_world_one_equal_kernel_one_on_each_route(device, mode, route):
    v_dim, h_dim, batch, steps = DP_SHAPE
    params, v_all, mask = _problem(device, v_dim, h_dim, batch, steps, mode, False)
    args = (params, v_all, mask, 1234, 1e-3, 2, mode, batch, 2)
    p_dp, s_dp = cd_gibbs_dp.cd_train_dp_emulated(1, *args, route=route)
    assert cd_gibbs_dp.last_launch()["route"] == route
    p_1, s_1 = cd_gibbs.cd_train_cuda(*args, route=route)
    torch.cuda.synchronize()
    assert cd_gibbs.last_launch()["route"] == route
    for name in NAMES:
        assert torch.equal(p_dp[name], p_1[name]), name
    assert torch.equal(s_dp, s_1)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_dp_kernels_at_world_one_equal_kernel_one_where_no_tile_divides(device, mode):
    # V 203 and H 97 are odd: every tile of the global route's plan (sides
    # multiples of 8) is ragged at the edges.
    params, v_all, mask = _problem(device, 203, 97, 40, 3, mode, False)
    args = (params, v_all, mask, 1234, 1e-3, 2, mode, 40, 2)
    p_dp, s_dp = cd_gibbs_dp.cd_train_dp_emulated(1, *args, route="global")
    assert cd_gibbs_dp.last_launch()["route"] == "global"
    p_1, s_1 = cd_gibbs.cd_train_cuda(*args, route="global")
    torch.cuda.synchronize()
    assert cd_gibbs_dp.last_launch()["tiles"] == cd_gibbs.last_launch()["tiles"] > 1
    for name in NAMES:
        assert torch.equal(p_dp[name], p_1[name]), name
    assert torch.equal(s_dp, s_1)


def test_dp_kernels_at_world_one_equal_kernel_one_over_batch_chunks(device):
    v_dim, h_dim, batch = CHUNK_CASES[0][:3]
    params, v_all, mask = _problem(device, v_dim, h_dim, batch, 2, 0, False)
    args = (params, v_all, mask, 1234, 1e-3, 1, 0, batch, 1)
    p_dp, s_dp = cd_gibbs_dp.cd_train_dp_emulated(1, *args, route="global")
    p_1, s_1 = cd_gibbs.cd_train_cuda(*args, route="global")
    torch.cuda.synchronize()
    assert cd_gibbs_dp.last_launch()["batch_tile"] == cd_gibbs.last_launch()["batch_tile"] < batch
    for name in NAMES:
        assert torch.equal(p_dp[name], p_1[name]), name
    assert torch.equal(s_dp, s_1)


@pytest.mark.parametrize("saturated", [True, False])
def test_dp_kernels_at_world_four_match_kernel_one(device, saturated):
    v_dim, h_dim, batch, steps = DP_SHAPE
    params, v_all, mask = _problem(device, v_dim, h_dim, batch, steps, 0, saturated)
    args = (params, v_all, mask, 1234, 1e-3, 1, 0, batch, 2 if saturated else 1)
    p_dp, s_dp = cd_gibbs_dp.cd_train_dp_emulated(4, *args)
    p_1, s_1 = cd_gibbs.cd_train_cuda(*args)
    torch.cuda.synchronize()
    for name in NAMES:
        torch.testing.assert_close(p_dp[name], p_1[name], rtol=1e-5, atol=1e-5,
                                   msg=name)
    torch.testing.assert_close(s_dp, s_1, rtol=1e-4, atol=1e-4)


def test_dp_wrappers_reject_what_the_kernels_do_not_take(device):
    params, v_all, mask = _problem(device, 8, 4, 4, 2, 0, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cd_gibbs_dp.cd_dp_stats_cuda(params, v_all[:4].cpu(), mask[:4], 0, 0,
                                     1, 0, 0)
    with pytest.raises(ValueError, match="float32"):
        cd_gibbs_dp.cd_dp_stats_cuda(params, v_all[:4].double(), mask[:4], 0,
                                     0, 1, 0, 0)
    buf = torch.zeros(cd_gibbs_dp.payload_size(8, 4) - 1, device=device)
    with pytest.raises(ValueError, match="does not fit"):
        cd_gibbs_dp.cd_dp_apply_cuda(params, buf, 1e-3, torch.zeros(2, device=device), 0)


def test_rbm_fit_with_a_mesh_launches_the_step_kernels(device):
    rng = np.random.default_rng(1)
    data = (rng.random((300, 50)) < 0.2).astype(np.float32)
    hps = {"lr": 1e-2, "batch_size": 32, "epochs": 3}
    mesh = make_mesh()
    try:
        before = (cd_gibbs.cd_train_cuda.launches, cd_gibbs_dp.cd_dp_stats_cuda.launches,
                  cd_gibbs_dp.cd_dp_apply_cuda.launches)
        rbm = RBM(hps, 16, seed=0).fit(data, verbose=0, mesh=mesh)
        dbn = DBN()
        dbn.add_stack(RBM({**hps, "epochs": 1}, 16, seed=1))
        dbn.add_stack(RBM({**hps, "epochs": 1}, 8, seed=2))
        dbn.fit(data, verbose=0, mesh=mesh)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    steps = 3 * 10 + 2 * 10
    assert cd_gibbs_dp.last_launch()["route"] == "cluster"
    assert cd_gibbs.cd_train_cuda.launches == before[0]
    assert cd_gibbs_dp.cd_dp_stats_cuda.launches == before[1] + steps
    assert cd_gibbs_dp.cd_dp_apply_cuda.launches == before[2] + steps
    assert rbm.last_scores.shape == (3 * 10,)
    assert torch.isfinite(rbm.last_scores).all()
    assert dbn.transform(data).shape == (300, 8)
    single = RBM(hps, 16, seed=0).fit(data, verbose=0)
    for name in NAMES:
        assert torch.equal(rbm.params[name], single.params[name]), name
    assert torch.equal(rbm.last_scores, single.last_scores)


# ---------------------------------------------------------------------------
# StyleGAN on cuDNN (no kernel of the port's own): the card's f32 (TF32 off)
# against the CPU in float64 from the same weights, within 1e-4 of the
# output's largest entry; the transposed conv and the stride-2 fused conv
# alone against the CPU in f32 (1e-5 of the largest entry); a second-order
# gradient through r1_penalty against the CPU in float64.
# ---------------------------------------------------------------------------

from ku_torch.loss_ext import r1_penalty  # noqa: E402
from ku_torch.models import StyleGANDiscriminator, StyleGANGenerator  # noqa: E402
from ku_torch.nn import FusedEqualizedLRConv2D, FusedEqualizedLRConv2DTranspose  # noqa: E402

# 128 px, so that the fused transposed conv (128-px maps) and the fused
# stride-2 conv (maps of 64 px and more) run; 8 channels at 128 px.
SG_NARROW = dict(resolution=128, ch_base=512, max_ch=32)


@pytest.fixture
def no_tf32(device, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return device


def _rel(got, want):
    got, want = got.detach().double().cpu(), want.detach().double()
    assert got.shape == want.shape
    return float((got - want).abs().max() / want.abs().max())


def _pair(cls, seed=0, **kw):
    """The module on the card and its float64 copy on the CPU, same weights."""
    cpu = cls(**kw, device="cpu", generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for p in cpu.parameters():  # biases and noise weights off their init
            if p.dim() == 1:
                p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(seed + 1))
    card = cls(**kw, device="cuda")
    card.load_state_dict(cpu.state_dict(), strict=True)
    return card, cpu.double()


def test_stylegan_generator_f32_matches_cpu_float64(no_tf32):
    conf = dict(SG_NARROW, latent_dim=16, dlatent_dim=32, dense1_dim=32,
                num_mapping_layers=3, num_classes=10, mixing_prob=None, trunc_cutoff=4)
    gen, gen64 = _pair(StyleGANGenerator, **conf)
    rng = np.random.default_rng(0)
    z1, z2 = (torch.from_numpy(rng.normal(size=(3, 16))) for _ in range(2))
    label = torch.from_numpy(rng.integers(0, 10, (3, 1)))
    with torch.no_grad():
        want = gen64((z1, label, z2), deterministic=True)
        got = gen((z1.float().cuda(), label.cuda(), z2.float().cuda()), deterministic=True)
    assert _rel(got, want) <= 1e-4


def test_stylegan_discriminator_f32_matches_cpu_float64(no_tf32):
    disc, disc64 = _pair(StyleGANDiscriminator, **SG_NARROW)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(-1, 1, (4, 128, 128, 3)))
    label = torch.from_numpy(rng.integers(0, 10, (4, 1)).astype(np.float64))
    with torch.no_grad():
        want = disc64((x, label))
        got = disc((x.float().cuda(), label.float().cuda()))
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("cls,shape,kw", [
    (FusedEqualizedLRConv2DTranspose, (2, 16, 12, 24), dict(strides=2, padding="same")),
    (FusedEqualizedLRConv2D, (2, 16, 12, 24), dict(strides=2, padding="same")),
    (FusedEqualizedLRConv2D, (2, 15, 11, 24), dict(strides=2, padding="same")),
])
def test_fused_convs_on_the_card_match_the_cpu(no_tf32, cls, shape, kw):
    cpu = cls(shape[-1], 40, 3, **kw, device="cpu",
              generator=torch.Generator().manual_seed(0))
    card = cls(shape[-1], 40, 3, **kw, device="cuda")
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(2).normal(size=shape).astype(np.float32))
    with torch.no_grad():
        assert _rel(card(x.cuda()), cpu(x)) <= 1e-5


def test_r1_penalty_second_order_on_the_card(no_tf32):
    disc, disc64 = _pair(StyleGANDiscriminator, resolution=16, ch_base=64, max_ch=32)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-1, 1, (4, 16, 16, 3)))
    label = torch.from_numpy(rng.integers(1, 10, (4, 1)).astype(np.float64))
    grads = []
    for module, dev, dtype in ((disc, "cuda", torch.float32), (disc64, "cpu", torch.float64)):
        lab = label.to(dev, dtype)
        pen = r1_penalty(lambda v, m=module, lab=lab: m((v, lab)), x.to(dev, dtype))
        pen.mean().backward()
        grads.append((pen.detach(), torch.cat([p.grad.reshape(-1) for p in module.parameters()
                                               if p.grad is not None])))
    (pen, g), (pen64, g64) = grads
    assert torch.isfinite(g).all()
    assert _rel(pen, pen64) <= 1e-4
    assert float((g.double().cpu() - g64).norm() / g64.norm()) <= 1e-3


# ---------------------------------------------------------------------------
# The GAN engine on the card (no kernel of the port's own): a StyleGAN step
# at tests/test_torch_stylegan.py's TEST_CONF in f32 (TF32 off) against the
# same step in float64 on the card, and fit_generator keeping its state
# there.
# ---------------------------------------------------------------------------

import itertools  # noqa: E402

from ku_torch.backprop import GAN, STYLE_GAN_SOFTPLUS_INVERSE_R1_GP  # noqa: E402

GAN_TEST_CONF = dict(resolution=16, ch_base=64, max_ch=32, latent_dim=16, dlatent_dim=32,
                     dense1_dim=32, num_mapping_layers=3, num_classes=10, label_usage=True,
                     mixing_prob=None, trunc_psi=0.7, trunc_cutoff=4)
GAN_TEST_DISC = dict(resolution=16, ch_base=64, max_ch=32, label_usage=True)
GAN_TEST_ENGINE = {
    "hps": {"composing_mode": STYLE_GAN_SOFTPLUS_INVERSE_R1_GP, "disc_k_step": 2,
            "r_gamma": 10.0, "epochs": 1, "batch_step": 2,
            "disc_ext_hps": {"lr": 1e-3, "beta_1": 0.0, "beta_2": 0.99},
            "gen_disc_hps": {"lr": 1e-3, "beta_1": 0.0, "beta_2": 0.99}},
    "nn_arch": {"gen_rng_streams": ["noise", "style"]},
}


def _gan_batches(n, seed=0, b=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = rng.integers(0, 10, size=(b, 1))
        out.append({"x": rng.normal(size=(b, 16, 16, 3)).astype(np.float32),
                    "z": (rng.normal(size=(b, 16)).astype(np.float32), label,
                          rng.normal(size=(b, 16)).astype(np.float32)),
                    "label": label.astype(np.float32)})
    return out


def _gan_pair(param_dtype, **gen_kw):
    """The engine on the card in `param_dtype`, from seeded CPU modules whose noise
    weights are 0 and whose constant and moving mean are drawn (a constant
    map with the noise off makes the first AdaIN's sigma 0)."""
    gen = StyleGANGenerator(**dict(GAN_TEST_CONF, **gen_kw), device="cpu",
                            generator=torch.Generator().manual_seed(0))
    disc = StyleGANDiscriminator(**GAN_TEST_DISC, device="cpu",
                                 generator=torch.Generator().manual_seed(1))
    draw = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("noise_weight"):
                p.zero_()
        gen.synthesis.const_input.normal_(generator=draw)
        gen.truncation.moving_mean.normal_(generator=draw)
    engine = GAN(GAN_TEST_ENGINE, gen.to("cuda", param_dtype), disc.to("cuda", param_dtype))
    return engine.compose_gan_with_mode().compile().init_state(seed=0)


def _gan_on(batch, dtype):
    z1, label, z2 = batch["z"]
    on = lambda a: torch.from_numpy(a).to("cuda", dtype)  # noqa: E731
    return {"x": on(batch["x"]), "z": (on(z1), torch.from_numpy(label).cuda(), on(z2)),
            "label": on(batch["label"])}


def _adam_spread(grads, deltas, lr=1e-3, b2=0.99, eps=1e-8):
    """The widest change of the sum of an entry's Adam updates (beta1 0)
    when each update's gradient moves within +-deltas[s] of grads[s]: a
    grid of 9 points a step. Where a gradient's range holds 0, the update
    can take either sign: there the bound is the whole range, twice the
    sum of the largest updates, lr sqrt((1 - b2^t) / (1 - b2)) at step t."""
    def total(gs):
        v, out = 0.0, 0.0
        for t, g in enumerate(gs, 1):
            v = b2 * v + (1 - b2) * g * g
            out = out + lr * g / (torch.sqrt(v / (1 - b2 ** t)) + eps)
        return out

    nominal = total(grads)
    spread = torch.zeros_like(nominal)
    for point in itertools.product(np.linspace(-1.0, 1.0, 9).tolist(), repeat=len(grads)):
        moved = total([g + o * d for g, o, d in zip(grads, point, deltas)])
        spread = torch.maximum(spread, (moved - nominal).abs())
    crosses = torch.zeros_like(nominal, dtype=torch.bool)
    for g, d in zip(grads, deltas):
        crosses |= g.abs() <= d
    whole = 2 * lr * sum(((1 - b2 ** t) / (1 - b2)) ** 0.5 for t in range(1, len(grads) + 1))
    return torch.where(crosses, torch.full_like(spread, whole), spread)


def _gan_params(engine):
    return {side: {n: p.detach().double().clone()
                   for n, p in getattr(engine, side).named_parameters()}
            for side in ("disc", "gen")}


def _gan_pieces(engine, on):
    """The step taken piece by piece as train_step takes it (the k fakes, k
    D updates, one G update): the losses, and each update's gradient by
    parameter name."""
    draws = engine.state["gen"].generator
    losses, grads = [], []

    def update(side, loss):
        names = [n for n, _ in getattr(engine, side).named_parameters()]
        g = torch.autograd.grad(loss, engine.state[side].params, allow_unused=True,
                                materialize_grads=True)
        grads.append(dict(zip(names, g)))
        engine.state[side].apply_gradients(g)
        losses.append(loss.detach())

    for batch, fake in zip(on, engine._gen_fakes(on[:2], draws)):
        update("disc", engine._disc_loss(batch, draws, fake))
    update("gen", engine._gen_loss(on[2], draws))
    return torch.stack(losses), grads


def test_gan_step_f32_matches_float64_on_the_card(no_tf32):
    """One f32 train_step (k = 2) against the same step in float64 taken
    piece by piece: the D losses, the G loss and the moving mean within
    1e-4 of their largest entry; the gradient of each update, f32 against
    float64 (both taken piece by piece), within 1e-4 of each tensor's
    largest entry, but the discriminator's output bias, a difference of the
    real and the fake rows' terms, within 8 f32 ulps of their summed
    magnitude (at most 2 sum|label| / B); each parameter's change over the
    step (after - before) within 1e-4 of the float64 change's largest
    entry, plus what gradients within their tolerance can move its Adam
    updates by (Adam's first update with beta1 0 has a slope of 1e5 at g =
    0), plus f32's rounding of each update (2^-24 of the entry's
    magnitude). A skipped update, or one of the wrong sign, misses by
    about lr. The noise weights move by about +-lr (their gradient is the
    noise's): |w| <= lr."""
    batches = _gan_batches(3)
    ref = _gan_pair(torch.float64)
    before = _gan_params(ref)
    losses64, grads64 = _gan_pieces(ref, [_gan_on(b, torch.float64) for b in batches])
    change64 = {side: {n: p - before[side][n] for n, p in after.items()}
                for side, after in _gan_params(ref).items()}
    _, grads = _gan_pieces(_gan_pair(torch.float32), [_gan_on(b, torch.float32)
                                                      for b in batches])
    engine = _gan_pair(torch.float32)
    d, g = engine.train_step([_gan_on(b, torch.float32) for b in batches], 2)
    for got, want in ((d, losses64[:2]), (g, losses64[2]),
                      (engine.gen.truncation.moving_mean, ref.gen.truncation.moving_mean)):
        assert _rel(got, want.cpu()) <= 1e-4
    deltas = []
    for i, (got, want) in enumerate(zip(grads, grads64)):
        assert got.keys() == want.keys()
        deltas.append({})
        for name, w in want.items():
            if name.endswith("noise_weight"):
                continue
            err = float((got[name].double() - w).abs().max())
            tol = 1e-4 * float(w.abs().max())
            if name == "dense_out.bias":
                tol = max(tol, 2.0 ** -20 * 2.0 * np.abs(batches[i]["label"]).sum() / 4)
            assert err <= tol, (i, name, err, tol)
            deltas[-1][name] = tol
    for side, updates in (("disc", range(2)), ("gen", range(2, 3))):
        n = len(updates)
        for name, after in _gan_params(engine)[side].items():
            got, want = after - before[side][name], change64[side][name]
            if name.endswith("noise_weight"):
                assert float(got.abs().max()) <= 1e-3 * (1 + 1e-5), name
                continue
            tol = (1e-4 * float(want.abs().max())
                   + _adam_spread([grads64[u][name] for u in updates],
                                  [deltas[u][name] for u in updates])
                   + n * 2.0 ** -24 * (before[side][name].abs() + 2 * n * 1e-3))
            assert ((got - want).abs() <= tol).all(), (side, name,
                                                      float((got - want).abs().max()))


def test_fit_generator_keeps_its_state_on_the_card(device):
    """bf16 fit_generator: a finite history; every parameter, buffer, Adam
    moment and the draws on the card."""
    engine = _gan_pair(torch.float32, dtype=torch.bfloat16, mixing_prob=0.9)
    history = engine.fit_generator(iter(_gan_batches(6)), verbose=0)
    assert np.isfinite(history["disc_ext_loss"]).all()
    assert np.isfinite(history["gen_disc_loss"]).all()
    assert engine.state["gen"].step == 2 and engine.state["disc"].step == 4
    tensors = [*engine.gen.parameters(), *engine.gen.buffers(), *engine.disc.parameters()]
    for side in ("gen", "disc"):
        for state in engine.state[side].optimizer.state.values():
            tensors += [state["exp_avg"], state["exp_avg_sq"]]
    assert all(t.device.type == "cuda" for t in tensors)
    assert engine.state["gen"].generator.device.type == "cuda"


# -- the layer-spec engine, checkpoints and image utilities on the card --------------

from ku_torch.backprop import make_autoencoder_from_encoder  # noqa: E402
from ku_torch.engine_ext import Stack, Trainer, spec  # noqa: E402
from ku_torch.image_utils import resize_batch  # noqa: E402
from ku_torch.io import CheckpointManager  # noqa: E402
from ku_torch.io.checkpoint import packed, trees_equal  # noqa: E402

SPEC_CASES = {
    "conv_odd_stride2": ((spec("conv2d", "c0", filters=8, kernel_size=3, strides=2,
                               activation="relu"),
                          spec("conv2d", "c1", filters=5, kernel_size=4, strides=2),
                          spec("flatten", "f"), spec("dense", "d", units=7)), (6, 13, 11, 3)),
    "dense_bn": ((spec("dense_bn", "bn0", units=24, activation="relu"),
                  spec("dense_bn", "bn1", units=8), spec("dense", "out", units=5)), (32, 40)),
    "transposes": ((spec("conv1d_transpose", "t1", filters=4, kernel_size=3, strides=2),
                    spec("reshape", "r", target_shape=(2, 5, 4)),
                    spec("conv2d_transpose", "t2", filters=3, kernel_size=3, strides=2)),
                   (2, 5, 4)),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_stack_on_the_card_matches_cpu_float64(no_tf32, case):
    """A Stack in f32 on the card against its float64 copy on the CPU: the
    training-mode and inference outputs and the batch statistics after the
    training-mode call, within 1e-5 of the largest entry."""
    specs, shape = SPEC_CASES[case]
    cpu = Stack(specs, shape, device="cpu", dtype=torch.float64,
                generator=torch.Generator().manual_seed(3))
    card = copy.deepcopy(cpu).to("cuda", torch.float32)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=shape))
    for deterministic in (False, True):
        want = cpu(x, deterministic=deterministic)
        got = card(x.to("cuda", torch.float32), deterministic=deterministic)
        assert _rel(got, want) <= 1e-5, (case, deterministic)
    for (name, b), (_, want) in zip(card.named_buffers(), cpu.named_buffers()):
        assert _rel(b, want) <= 1e-5, name


def test_autoencoder_trainer_step_keeps_its_state_on_the_card(device):
    specs = (spec("dense_bn", "e0", units=16, activation="relu"), spec("dense", "e1", units=4))
    model = make_autoencoder_from_encoder(specs, (8, 12), device="cuda")
    trainer = Trainer(model, lambda y, p: ((y - p) ** 2).mean(dim=-1), has_batch_stats=True)
    x = np.random.default_rng(5).normal(size=(24, 12)).astype(np.float32)
    history = trainer.fit(x, x, batch_size=8, epochs=2, verbose=0)
    assert np.isfinite(history).all()
    assert all(t.device.type == "cuda" for t in [*model.parameters(), *model.buffers()])
    assert float(model.encoder.e0.BatchNorm_0.var.sum()) != 16.0  # the statistics moved


def test_checkpoint_restores_a_card_state_bit_for_bit(device, tmp_path):
    from ku_torch.core import TrainState
    from ku_torch.engine_ext import adam

    def state(seed):
        torch.manual_seed(seed)
        module = torch.nn.Linear(6, 4).to("cuda")
        draws = torch.Generator(device="cuda").manual_seed(seed)
        st = TrainState.create(module.parameters(), adam(1e-2), draws)
        st.apply_gradients([torch.randn(p.shape, device="cuda", generator=draws)
                            for p in st.params])
        return {"train": st, "buffer": torch.randn(3, device="cuda", generator=draws)}

    saved = state(0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, saved)
    target = state(1)
    mgr.restore(0, template=target)
    assert trees_equal(packed(target), packed(saved))
    assert all(t.device.type == "cuda" for t in [*target["train"].params, target["buffer"]])
    for st in target["train"].optimizer.state.values():
        assert st["exp_avg"].device.type == "cuda"
    a = torch.rand(4, device="cuda", generator=target["train"].generator)
    b = torch.rand(4, device="cuda", generator=saved["train"].generator)
    assert torch.equal(a, b)


def test_resize_on_the_card_matches_the_cpu(device):
    imgs = np.random.default_rng(6).uniform(size=(2, 37, 21, 3)).astype(np.float32)
    for size in ((16, 16), (40, 9), (64, 64)):
        got = resize_batch(torch.from_numpy(imgs).to("cuda"), size)
        want = resize_batch(imgs, size)
        assert got.device.type == "cuda"
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The rest of serving: int8 weights, the ring cache, beam search.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(2048, 512), (64, 48), (40, 20)])
def test_int8_act_matmul_pads_its_rows_on_the_card(device, dtype, k, n):
    """torch._int_mm on the card takes more than 16 rows (and a K, N it has a
    product for): a decode step's 8 rows are padded and sliced off, and the
    product equals the CPU's: in f32 to 1e-6, in bf16 to one bf16 ulp. (A
    scale divided by the Python number 127 on the card is a product with
    its reciprocal, an ulp off the CPU's quotient; bf16 inputs then land
    on rounding ties that flip whole int8 steps. The port divides by a
    tensor.)"""
    from ku_torch.nn import int8_act_matmul

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(8, 1, k)).astype(np.float32)).to(dtype)
    wq = torch.from_numpy(rng.integers(-127, 128, size=(k, n)).astype(np.int8))
    sc = torch.from_numpy(rng.uniform(0.01, 0.05, size=(n,)).astype(np.float32))
    padded, calls = int8_act_matmul.padded, int8_act_matmul.int_mm_calls
    got = int8_act_matmul(x.to(device), wq.to(device), sc.to(device))
    assert int8_act_matmul.padded == padded + 1
    assert int8_act_matmul.int_mm_calls == calls + 1
    want = int8_act_matmul(x, wq, sc)
    assert got.shape == (8, 1, n) and got.dtype == dtype
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else dict(rtol=2**-8, atol=1e-6)
    torch.testing.assert_close(got.cpu(), want, **tol)


def _twin(cls, device, *args, **kw):
    cpu = cls(*args, device="cpu", generator=torch.Generator().manual_seed(0), **kw)
    card = cls(*args, device=device, **kw)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


@torch.no_grad()
def test_ring_prefill_launches_flash_and_its_steps_no_decode_kernel(device):
    """A ring with use_flash: the banded prefill is one flash launch, the
    per-token steps read the ring in plain torch (no decode kernel), and
    every output equals the CPU's."""
    from ku_torch.kernels import decode_attention as da
    from ku_torch.kernels import flash_attention as fa
    from ku_torch.nn import MultiHeadAttention

    cpu, card = _twin(MultiHeadAttention, device, 4, 64, 0.0, causal=True, window=16,
                      num_kv_head=2, use_flash=True, rope=True)
    x = torch.randn(2, 60, 64, generator=torch.Generator().manual_seed(1))
    flash, dec = fa.flash_fwd_cuda.launches, da.decode_attention_cuda.launches
    xc = x.to(device)
    chunk, chunk_c = x[:, :40], xc[:, :40]
    want, cache = cpu([chunk, chunk, chunk], decode=True)
    got, cache_c = card([chunk_c, chunk_c, chunk_c], decode=True)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert fa.flash_fwd_cuda.launches == flash + 1
    for i in range(40, 60):
        tok, tok_c = x[:, i:i + 1], xc[:, i:i + 1]
        want, cache = cpu([tok, tok, tok], decode=True, cache=cache)
        got, cache_c = card([tok_c, tok_c, tok_c], decode=True, cache=cache_c)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert da.decode_attention_cuda.launches == dec
    assert torch.equal(cache_c["cache_pos"].cpu(), cache["cache_pos"])
    assert tuple(cache_c["cached_key"].shape) == (2, 2, 16, 16)


def test_beam_steps_launch_the_decode_kernel(device):
    """Each beam step reads the forked, regathered cache through the dense
    decode kernel (one launch an attention sublayer), and the beams equal
    the CPU's."""
    from ku_torch.kernels import decode_attention as da
    from ku_torch.nn import Transformer, beam_search

    cpu, card = _twin(Transformer, device, 4, 64, 0.0, causal=True, num_kv_head=2,
                      max_decode_len=24, rope=True)
    table = torch.randn(11, 64, generator=torch.Generator().manual_seed(2))
    table_c = table.to(device)
    ids = torch.randint(0, 11, (2, 8), generator=torch.Generator().manual_seed(3))
    dec = da.decode_attention_cuda.launches
    got, got_s = beam_search(card, ids.to(device), 6, beam_size=3,
                             embed=lambda i, p=None: table_c[i],
                             readout=lambda y: y @ table_c.T)
    assert da.decode_attention_cuda.launches == dec + 2 * 5
    want, want_s = beam_search(cpu, ids, 6, beam_size=3, embed=lambda i, p=None: table[i],
                               readout=lambda y: y @ table.T)
    assert torch.equal(got.cpu(), want)
    torch.testing.assert_close(got_s.cpu(), want_s, rtol=1e-4, atol=1e-4)


def test_quantize_weights_on_the_card_equals_the_cpu(device):
    """Scales and int8 kernels quantized on the card equal the CPU's (and so
    ku's) bit for bit, an all-zero column included."""
    from ku_torch.nn import QuantDense, quantize_weights

    w = torch.randn(96, 40, generator=torch.Generator().manual_seed(4))
    w[:, 3] = 0.0
    sd = {"kernel": w, "bias": torch.zeros(40)}
    want = quantize_weights(sd, QuantDense(96, 40, device="cpu"))
    got = quantize_weights({k: v.to(device) for k, v in sd.items()},
                           QuantDense(96, 40, device=device))
    for name, value in want.items():
        assert torch.equal(got[name].cpu(), value), name


# -- The int8 KV scales, the NobodyConvNet step, export, the native loader


def _identity_kv(module):
    """K and V projections set to the identity, so that the cache holds the
    inputs themselves on either device (TF32 off)."""
    with torch.no_grad():
        for name in ("W_K", "W_V"):
            getattr(module, name).copy_(torch.eye(getattr(module, name).shape[0]))
    return module


def _flat_cache(cache, prefix=""):
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(_flat_cache(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def test_int8_kv_quantize_on_the_card_equals_the_cpu(device):
    """The scales divide by 127 as a tensor on the card (quant._127): a
    division by the Python number multiplies by its reciprocal there."""
    from ku_torch.nn.attention import _quantize

    g = torch.Generator().manual_seed(15)
    x = torch.randn(4096, 128, generator=g) * torch.rand(4096, 1, generator=g).exp2() * 3
    for dtype in (torch.float32, torch.bfloat16):
        q_cpu, s_cpu = _quantize(x.to(dtype))
        q_card, s_card = _quantize(x.to(dtype).to(device))
        assert torch.equal(s_card.cpu(), s_cpu), dtype
        assert torch.equal(q_card.cpu(), q_cpu), dtype


@pytest.mark.parametrize("paged", [False, True])
def test_int8_kv_cache_on_the_card_equals_the_cpu(device, monkeypatch, paged):
    """A prefill into an int8 cache, dense and paged, writes the same int8
    K/V and scales on the card as on the CPU, bit for bit."""
    from ku_torch.nn import MultiHeadAttention

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    kw = dict(kv_cache_dtype="int8", causal=True, max_decode_len=32,
              **({"kv_page_size": 8} if paged else {}))
    cpu = _identity_kv(MultiHeadAttention(4, 64, **kw, device="cpu",
                                          generator=torch.Generator().manual_seed(1)))
    card = MultiHeadAttention(4, 64, **kw, device=device)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 20, 64, generator=g) * torch.rand(3, 20, 1, generator=g).exp2() * 5
    _, want = cpu([x, x, x], decode=True, cache={})
    _, got = card([x.to(device)] * 3, decode=True, cache={})
    want, got = _flat_cache(want), _flat_cache(got)
    assert got.keys() == want.keys()
    assert any("scale" in k for k in want)
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v), k


def test_nobody_convnet2d_step_on_cudnn_matches_cpu_float64(no_tf32):
    """The MNIST classifier at its conf: a training-mode forward (output and
    batch statistics) within 1e-4 of float64 on the CPU, and one SGD step's
    parameter changes within 1e-2 of the float64 change's largest entry
    (cuDNN's f32 convolutions, as the GAN step's gradients)."""
    import functools

    from examples_torch import common
    from examples_torch.mnist_digit_classfication import nobody_convnet2d_mnist as ex
    from ku_torch.core.config import load_config
    from ku_torch.engine_ext import Trainer

    conf = load_config(ex.CONF_PATH)
    V, gt = common.mnist_like(16, seed=3)
    x = torch.from_numpy(V.reshape(-1, 28, 28, 1))
    ref = ex.ConvNetClassifier(conf, (16, 28, 28, 1), device="cpu", dtype=torch.float64,
                               generator=torch.Generator().manual_seed(5))
    card = copy.deepcopy(ref).to("cuda", torch.float32)
    before = {n: p.detach().clone() for n, p in ref.named_parameters()}
    sgd = functools.partial(torch.optim.SGD, lr=0.1)
    for module, rows in ((ref, x.double()), (card, x.cuda())):
        _, out = Trainer(module, ex.loss_fn, optimizer=sgd, has_batch_stats=True)._train_step(
            rows, torch.from_numpy(gt).to(rows.device))
        if module is ref:
            want_out = out
    assert _rel(out, want_out) <= 1e-4
    for n, b in ref.named_buffers():
        assert _rel(dict(card.named_buffers())[n], b) <= 1e-4, n
    changes = {n: p.detach() - before[n] for n, p in ref.named_parameters()}
    largest = max(float(c.abs().max()) for c in changes.values())
    for n, p in card.named_parameters():
        err = float((p.detach().double().cpu() - before[n] - changes[n]).abs().max())
        assert err <= 1e-2 * float(changes[n].abs().max()) + 1e-6 * largest, n


def test_export_round_trip_on_the_card(device, tmp_path):
    from examples_torch.mnist_digit_classfication import nobody_convnet2d_mnist as ex
    from ku_torch.core.config import load_config
    from ku_torch.io import export_fn, load_exported

    model = ex.ConvNetClassifier(load_config(ex.CONF_PATH), (8, 28, 28, 1), device=device,
                                 generator=torch.Generator(device=device).manual_seed(0))
    x = torch.rand(8, 28, 28, 1, device=device) * 255
    path = str(tmp_path / "m.pt2")
    export_fn(lambda v: model(v, deterministic=True), (x,), path)
    with torch.no_grad():
        got, want = load_exported(path).call(x), model(x, deterministic=True)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_export_refuses_a_flash_block_by_name(device, tmp_path):
    from ku_torch.io import export_fn
    from ku_torch.kernels._build import KernelTraceError
    from ku_torch.nn import MultiHeadAttention

    block = MultiHeadAttention(4, 64, use_flash=True, causal=True, device=device)
    q = torch.randn(2, 16, 64, device=device)
    with pytest.raises(KernelTraceError, match="flash_fwd_cuda"):
        export_fn(lambda v: block([v, v, v]), (q,), str(tmp_path / "f.pt2"))
    assert not (tmp_path / "f.pt2").exists()


def test_native_loader_builds_into_the_port(device):
    from pathlib import Path

    from ku_torch import native

    lib = Path(native.load()._name)
    assert lib.parent == Path(native.__file__).resolve().parent.parent / "_build"
    pipe = native.NativeImagePipeline(16, 16, n_threads=4)
    pipe.submit(np.full((20, 10, 3), 200, np.uint8))
    out = pipe.get()
    pipe.close()
    assert out.shape == (16, 16, 3) and np.isclose(out[8, 8, 0], 200 * 2 / 255 - 1)
