"""The CD kernels' cluster route (kernels #1 and #2) on the CPU: its plan,
and a torch model of the order in which it sums.

On the card one thread-block cluster holds W split by visible rows: block r
owns rows_r and columns cols_r (``cluster_plan``), the batch is taken in
tiles, each hidden activation is the sum of the blocks' partials over their
rows_r taken in rank order, each free energy the sum of the blocks' shares
(visible terms over rows_r, softplus terms over cols_r) in rank order, and
dW_r, the b_h and b_v sums and the score sums accumulate tile by tile, the
positive term before the negative one.
Here that order is replayed in torch (``cluster_step_sums``) and held
against the plain version's one-pass sums (``step_sums_torch``) in float64
within rtol/atol 1e-6 (in float32 the two orders of a sum of 128 rows with
cancellation differ by up to 5e-5 at these sizes; float64 checks that the
order computes the same function) and, with the all-zero draws of ku's
interpreter, against ku's Pallas kernel in interpret mode
(tests/test_torch_cd_gibbs_stub.py's limits: params rtol 1e-5 / atol 1e-6,
scores rtol 1e-4 / atol 1e-5). The card tests hold the C entry's plan
against ``cluster_plan`` and the kernels against the plain versions
(tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ku.pallas.cd_gibbs import cd_epoch_pallas
from ku_torch.core.rng import box_muller, philox_uniforms
from ku_torch.kernels import cd_gibbs
from ku_torch.kernels.cd_gibbs import (
    MODE_COMPLEX,
    MODE_VISIBLE_BERNOULLI,
    MODE_VISIBLE_GAUSSIAN,
    cluster_plan,
    step_sums_torch,
)
from ku_torch.utility import params_from_numpy, params_to_numpy

# (batch, V, H): the RBM / DBN path, the card tests', a data-parallel rank's
# rows, and V that 16 and 8 blocks do not divide.
PATH = [(128, 784, 128), (128, 784, 256), (128, 256, 128)]
CARD = [(40, 37, 45), (16, 6, 4), (150, 200, 70), (10, 37, 45), (32, 784, 128)]
RAGGED = [(128, 100, 128), (64, 37, 130), (7, 3, 20)]
SHAPES = PATH + CARD + RAGGED


@pytest.mark.parametrize("cluster", [16, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_cluster_plan_covers_v_and_h_once_in_rank_order(shape, cluster):
    batch, v_dim, h_dim = shape
    plan = cluster_plan(batch, v_dim, h_dim, cluster)
    for key, n in (("rows", v_dim), ("cols", h_dim)):
        spans = plan[key]
        assert len(spans) == cluster
        covered = [i for start, count in spans for i in range(start, start + count)]
        assert covered == list(range(n))
        assert max(count for _, count in spans) - min(count for _, count in spans) <= 1
    assert plan["nr"] == max(c for _, c in plan["rows"])
    assert plan["hc"] == max(c for _, c in plan["cols"])
    if plan["route"] == "cluster":
        assert 0 < plan["smem_bytes"] <= cd_gibbs.SMEM_BUDGET == 232_448
        bt = plan["batch_tile"]
        assert plan["tiles"] == -(-batch // bt)
        # The largest tile that fits: one row more would need a tile fewer.
        if plan["tiles"] > 1:
            fewer = -(-batch // (plan["tiles"] - 1))
            assert 4 * cd_gibbs._plan_floats(fewer, plan["nr"], plan["hc"], h_dim,
                                             cluster) > cd_gibbs.SMEM_BUDGET


@pytest.mark.parametrize("shape", SHAPES)
def test_path_and_card_shapes_take_the_cluster_route(shape):
    assert cd_gibbs.route_for(*shape) == "cluster"
    assert cluster_plan(*shape)["route"] == "cluster"


@pytest.mark.parametrize("shape", [(128, 4096, 1024), (128, 2000, 2000), (8, 784, 4096)])
def test_a_w_past_the_budget_takes_the_global_route(shape):
    plan = cluster_plan(*shape)
    assert plan["route"] == "global" and plan["batch_tile"] == 0
    assert cd_gibbs.route_for(*shape) == "global"


def test_routes_are_checked_before_any_launch():
    with pytest.raises(ValueError, match="route"):
        cd_gibbs._route_code("fast", 8, 4, 4)
    with pytest.raises(ValueError, match="cluster"):
        cd_gibbs._cluster_code(4)
    assert cd_gibbs._route_code(None, 128, 784, 128) == cd_gibbs.ROUTES.index("cluster")
    assert cd_gibbs._route_code(None, 128, 4096, 1024) == cd_gibbs.ROUTES.index("global")


def _rank_sum(parts):
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def cluster_step_sums(w, bh, bv, v_pos, m, u, k, mode, cluster=16):
    """step_sums_torch's function in the cluster route's order of sums."""
    batch, v_dim = v_pos.shape
    h_dim = w.shape[1]
    plan = cluster_plan(batch, v_dim, h_dim, cluster)
    rows = [slice(s, s + c) for s, c in plan["rows"]]
    cols = [slice(s, s + c) for s, c in plan["cols"]]
    bt = plan["batch_tile"]
    cx = mode == MODE_COMPLEX

    def act(v):  # the partials of every block, summed in rank order
        a = _rank_sum([v[:, r] @ w[r] for r in rows])
        return (2.0 * a if cx else a) + bh

    def free_energy(v, a):  # each block's share, summed in rank order
        shares = []
        for r, c in zip(rows, cols):
            vis = ((v[:, r] - bv[r]) ** 2 if cx else v[:, r] * bv[r]).sum(1)
            sp = cd_gibbs._softplus30(a[:, c]).sum(1)
            shares.append(vis - sp if cx else -(vis + sp))
        return _rank_sum(shares)

    d_w = torch.zeros_like(w)
    d_bh, d_bv = torch.zeros_like(bh), torch.zeros_like(bv)
    diff_sum = torch.zeros((), dtype=w.dtype)
    m_sum = torch.zeros((), dtype=w.dtype)
    for b0 in range(0, batch, bt):
        t = slice(b0, min(b0 + bt, batch))
        vp, mt, ut = v_pos[t], m[t], u[:, t]
        a_pos = act(vp)
        p = torch.relu(a_pos) if mode == MODE_VISIBLE_GAUSSIAN else torch.sigmoid(a_pos)
        h_pos = (ut[0, :, :h_dim] < p).to(w.dtype) * mt
        h = h_pos
        for i in range(k):
            stat = torch.cat([h @ w[r].T for r in rows], dim=1) + bv
            if mode == MODE_VISIBLE_BERNOULLI:
                v_neg = (ut[1 + 3 * i, :, :v_dim] < torch.sigmoid(stat)).to(w.dtype)
            else:
                z = box_muller(ut[1 + 3 * i, :, :v_dim], ut[2 + 3 * i, :, :v_dim])
                v_neg = stat + (cd_gibbs._INV_SQRT2 * z if cx else z)
            v_neg = v_neg * mt
            a_neg = act(v_neg)
            if i == 0:
                fe_neg = free_energy(v_neg, a_neg)
            h_neg = torch.sigmoid(a_neg) * mt
            if i < k - 1:
                p_h = torch.relu(a_neg) * mt if mode == MODE_VISIBLE_GAUSSIAN else h_neg
                h = (ut[3 + 3 * i, :, :h_dim] < p_h).to(w.dtype)
        vp_m = vp * mt
        # The positive sums of the tile, then its negative ones.
        d_w = d_w + vp_m.T @ h_pos
        d_bh = d_bh + h_pos.sum(0)
        d_bv = d_bv + vp_m.sum(0)
        d_w = d_w - v_neg.T @ h_neg
        d_bh = d_bh - h_neg.sum(0)
        d_bv = d_bv - v_neg.sum(0)
        diff = (free_energy(vp, a_pos) - fe_neg).abs() * mt[:, 0]
        diff_sum = diff_sum + diff.sum()
        m_sum = m_sum + mt.sum()
    return d_w, d_bh, d_bv, diff_sum, m_sum


def _problem(rng, batch, v_dim, h_dim, mode, ragged):
    w = torch.from_numpy(rng.normal(scale=0.1, size=(v_dim, h_dim)).astype(np.float32))
    bh = torch.from_numpy(rng.normal(scale=0.1, size=h_dim).astype(np.float32))
    bv = torch.from_numpy(rng.normal(scale=0.1, size=v_dim).astype(np.float32))
    if mode == MODE_VISIBLE_BERNOULLI:
        v = (rng.random((batch, v_dim)) < 0.3).astype(np.float32)
    else:
        v = rng.normal(size=(batch, v_dim)).astype(np.float32)
    m = np.ones((batch, 1), np.float32)
    if ragged:
        m[-(batch // 3):] = 0.0
        v[-(batch // 3):] = 0.0
    return w, bh, bv, torch.from_numpy(v), torch.from_numpy(m)


ORDER_CASES = [
    (128, 784, 128, MODE_VISIBLE_BERNOULLI, 1, False),   # the RBM path: 2 tiles
    (128, 784, 256, MODE_VISIBLE_BERNOULLI, 1, True),    # the DBN's first layer
    (40, 37, 45, MODE_VISIBLE_GAUSSIAN, 2, True),
    (40, 37, 45, MODE_COMPLEX, 3, False),
    (64, 100, 70, MODE_VISIBLE_BERNOULLI, 2, True),      # V that C does not divide
]


# Every case at each cluster size that has a plan for it (784 x 256 has none
# at 8 blocks: that card takes the global route there).
@pytest.mark.parametrize("case,cluster", [
    (case, cluster) for case in ORDER_CASES for cluster in (16, 8)
    if cluster_plan(*case[:3], cluster)["route"] == "cluster"])
def test_cluster_order_of_sums_is_the_plain_step(case, cluster):
    batch, v_dim, h_dim, mode, k, ragged = case
    rng = np.random.default_rng(7)
    w, bh, bv, v, m = (x.double() for x in _problem(rng, batch, v_dim, h_dim, mode,
                                                     ragged))
    u = philox_uniforms(99, 3, 3 * k + 1, batch, max(v_dim, h_dim)).double()
    want = step_sums_torch(w, bh, bv, v, m, u, k, mode)
    got = cluster_step_sums(w, bh, bv, v, m, u, k, mode, cluster)
    for name, g, x in zip(("d_w", "d_bh", "d_bv", "diff", "mask"), got, want):
        torch.testing.assert_close(g, x, rtol=1e-6, atol=1e-6, msg=name)


def _zero_uniforms(step, n_streams, rows, cols):
    return torch.zeros(n_streams, rows, cols)


@pytest.mark.parametrize("mode,k", [(MODE_VISIBLE_GAUSSIAN, 2), (MODE_COMPLEX, 1)])
def test_cluster_order_replays_ku_interpret_kernel(rng, mode, k):
    """tests/test_torch_cd_gibbs_stub.py's replay, each step's sums taken in
    the cluster route's order (batch 8 in one tile, V 6 over 16 blocks)."""
    v_dim, h_dim, batch, steps = 6, 4, 8, 3
    p_np = {
        "rbm_weight": rng.normal(scale=0.1, size=(v_dim, h_dim)).astype(np.float32),
        "hidden_bias": rng.normal(scale=0.1, size=(h_dim,)).astype(np.float32),
        "visible_bias": rng.normal(scale=0.1, size=(v_dim,)).astype(np.float32),
    }
    n = batch * steps - 3
    data = rng.normal(size=(batch * steps, v_dim)).astype(np.float32)
    data[n:] = 0.0
    mask = np.zeros((batch * steps,), np.float32)
    mask[:n] = 1.0

    p = params_from_numpy(p_np, "cpu")
    w, bh, bv = p["rbm_weight"], p["hidden_bias"], p["visible_bias"]
    v_all, m_all = torch.from_numpy(data), torch.from_numpy(mask)
    scores = []
    for s in range(steps):
        rows = slice(s * batch, (s + 1) * batch)
        d_w, d_bh, d_bv, diff, msum = cluster_step_sums(
            w, bh, bv, v_all[rows], m_all[rows, None],
            _zero_uniforms(s, 3 * k + 1, batch, max(v_dim, h_dim)), k, mode)
        scores.append(diff / msum.clamp_min(1.0))
        w, bh, bv = w + 1e-3 * d_w, bh + 1e-3 * d_bh, bv + 1e-3 * d_bv
    p_pt = params_to_numpy({"rbm_weight": w, "hidden_bias": bh, "visible_bias": bv})

    p_pl, s_pl = cd_epoch_pallas({n_: jnp.asarray(x) for n_, x in p_np.items()},
                                 jnp.asarray(data), jnp.asarray(mask),
                                 jax.random.key(5), 1e-3, k, mode, batch,
                                 interpret=True)
    for name in p_np:
        assert np.abs(p_pt[name] - p_np[name]).max() > 1e-4
        np.testing.assert_allclose(p_pt[name], np.asarray(p_pl[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(torch.stack(scores).numpy(), np.asarray(s_pl),
                               rtol=1e-4, atol=1e-5)
