"""ku_torch's layer-spec engine, encoder reversal, progressive surgery and
batch-statistics Trainer against ku's, on the CPU.

The same numpy-made inputs and ku's variables (carried across by
``state_dict_from_tree``, batch statistics included) go through both
packages. Tolerance: 1e-5 of each tensor's largest entry (REL) for the
outputs, the statistics and the parameters after an SGD step, f32 in both
with the sums in other orders; ``Trainer.fit`` as
tests/test_torch_training.py holds it, the losses by epoch at rtol 1e-4 and
the final parameters and ``batch_stats`` at atol 1e-5 (Adam moves a
parameter by about lr a step whatever its gradient's size; its eps is
1e-4 there, see the test). Shapes, specs and JSON forms exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ku.backprop import autoencoder as ku_ae
from ku.engine_ext import Stack as KuStack
from ku.engine_ext import Trainer as KuTrainer
from ku.engine_ext import infer_shapes as ku_infer_shapes
from ku.engine_ext import spec as ku_spec
from ku.engine_ext import training as ku_training
from ku_torch.backprop import autoencoder as ae
from ku_torch.engine_ext import (
    PROGRESSIVE_MODE_BACKWARD,
    PROGRESSIVE_MODE_FORWARD,
    LayerSpec,
    Stack,
    Trainer,
    adam,
    create_prog_specs,
    glue_layers,
    infer_shapes,
    param_tree,
    select_params,
    spec,
    train_on_batch_backward_prog_model,
    train_on_batch_forward_prog_model,
)
from ku_torch.utility import params_from_numpy, state_dict_from_tree, variables_from_module

REL = 1e-5
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: {err:.3e} > {tol:.3e}"


def _close_trees(got, want, rel=REL, what=""):
    assert got.keys() == want.keys(), (what, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _close_trees(got[k], want[k], rel, f"{what}/{k}")
        else:
            _close(got[k], want[k], rel, f"{what}/{k}")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _both(names_and_config):
    """The same specs in both packages."""
    return (tuple(ku_spec(k, n, **c) for k, n, c in names_and_config),
            tuple(spec(k, n, **c) for k, n, c in names_and_config))


def _load(module, variables):
    module.load_state_dict(state_dict_from_tree(
        variables.get("params", {}), CPU, batch_stats=variables.get("batch_stats")),
        strict=True)
    return module


def _inputs(shape, seed=0, adjacency=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if adjacency is None:
        return x, None
    a = (rng.uniform(size=adjacency) < 0.4).astype(np.float32)
    return x, np.maximum(a, np.swapaxes(a, -1, -2))


# -- Stack, kind by kind ---------------------------------------------------------

# name -> (specs as (kind, name, config), input shape, adjacency shape or None)
KINDS = {
    "dense": ([("dense", "d0", dict(units=5, activation="relu")),
               ("dense", "d1", dict(units=3, use_bias=False))], (4, 7), None),
    "dense_on_rank3": ([("dense", "d0", dict(units=5, activation="tanh"))], (2, 3, 4), None),
    "conv1d_s1": ([("conv1d", "c", dict(filters=4, kernel_size=3, activation="relu"))],
                  (2, 9, 3), None),
    "conv1d_s2_odd": ([("conv1d", "c", dict(filters=4, kernel_size=4, strides=2))],
                      (2, 9, 3), None),
    "conv2d_s1": ([("conv2d", "c", dict(filters=4, kernel_size=3))], (2, 7, 5, 3), None),
    "conv2d_s2_odd": ([("conv2d", "c", dict(filters=4, kernel_size=(3, 4), strides=2,
                                            activation="elu"))], (2, 9, 7, 3), None),
    "conv2d_valid": ([("conv2d", "c", dict(filters=2, kernel_size=3, padding="valid"))],
                     (1, 6, 6, 2), None),
    "conv3d_s1": ([("conv3d", "c", dict(filters=3, kernel_size=3))], (1, 5, 4, 3, 2), None),
    "conv3d_s2_odd": ([("conv3d", "c", dict(filters=3, kernel_size=2, strides=2))],
                      (1, 5, 7, 3, 2), None),
    "conv1d_transpose_s2": ([("conv1d_transpose", "t", dict(filters=3, kernel_size=3,
                                                            strides=2))], (2, 5, 4), None),
    "conv2d_transpose_s2": ([("conv2d_transpose", "t", dict(filters=3, kernel_size=(3, 4),
                                                            strides=2, activation="relu"))],
                            (2, 5, 3, 4), None),
    "conv3d_transpose_s2": ([("conv3d_transpose", "t", dict(filters=2, kernel_size=3,
                                                            strides=2))], (1, 3, 2, 3, 2), None),
    "gcn": ([("gcn", "g", dict(n_node=5, d_out=3, activation="relu"))], (2, 5, 4), (2, 5, 5)),
    "gcn_output_adjacency": ([("gcn", "g0", dict(n_node=5, d_out=6, output_adjacency=True,
                                                 activation="tanh")),
                              ("gcn", "g1", dict(n_node=5, d_out=3))], (2, 5, 4), (2, 5, 5)),
    "upsampling": ([("upsampling1d", "u1", dict(size=2)),
                    ("reshape", "r", dict(target_shape=(4, 3, 2))),
                    ("upsampling2d", "u2", dict(size=(2, 3))),
                    ("reshape", "r2", dict(target_shape=(2, 4, 9, 2))),
                    ("upsampling3d", "u3", dict(size=2))], (2, 6, 2), None),
    "flatten_reshape": ([("conv2d", "c", dict(filters=3, kernel_size=3, strides=2)),
                         ("flatten", "f", {}),
                         ("dense", "d", dict(units=12)),
                         ("reshape", "r", dict(target_shape=(2, 2, 3))),
                         ("activation", "a", dict(activation="sigmoid"))], (2, 5, 3, 2), None),
}


@functools.lru_cache(maxsize=None)
def _ku_stack(case):
    configs, shape, adj_shape = KINDS[case]
    ku_specs, _ = _both(configs)
    x, a = _inputs(shape, adjacency=adj_shape)
    module = KuStack(specs=ku_specs)
    inp = [jnp.asarray(x), jnp.asarray(a)] if a is not None else jnp.asarray(x)
    out, variables = jax.jit(module.init_with_output)(jax.random.key(1), inp)
    return _np(variables), np.asarray(out)


@pytest.mark.parametrize("case", sorted(KINDS))
def test_stack_matches_ku(case):
    configs, shape, adj_shape = KINDS[case]
    _, specs = _both(configs)
    variables, want = _ku_stack(case)
    x, a = _inputs(shape, adjacency=adj_shape)
    stack = _load(Stack(specs, shape, adj_shape, device=CPU), variables)
    got = stack([torch.from_numpy(x), torch.from_numpy(a)] if a is not None
                else torch.from_numpy(x))
    _close(got, want, what=case)
    # The port's variables are ku's under the same names.
    back = variables_from_module(stack)
    _close_trees(back["params"], variables.get("params", {}), 0.0, "params")


@pytest.mark.parametrize("case", sorted(KINDS))
def test_infer_shapes_matches_ku(case):
    configs, shape, adj_shape = KINDS[case]
    ku_specs, specs = _both(configs)
    assert infer_shapes(specs, shape, adj_shape) == ku_infer_shapes(ku_specs, shape, adj_shape)


DENSE_BN = [("dense_bn", "bn0", dict(units=6, activation="relu")),
            ("dense_bn", "bn1", dict(units=4)),
            ("dense", "out", dict(units=3))]


@functools.lru_cache(maxsize=None)
def _ku_dense_bn():
    ku_specs, _ = _both(DENSE_BN)
    x, _ = _inputs((8, 5), seed=2)
    module = KuStack(specs=ku_specs)
    variables = _np(module.init(jax.random.key(2), jnp.asarray(x)))
    # Running statistics away from their initial zeros and ones.
    rng = np.random.default_rng(3)
    variables["batch_stats"] = jax.tree.map(
        lambda v: (rng.uniform(0.5, 1.5, v.shape) if v.ndim else v).astype(np.float32),
        variables["batch_stats"])
    train = jax.jit(lambda v, x: module.apply(v, x, deterministic=False,
                                              mutable=["batch_stats"]))
    y_train, mutated = train(variables, jnp.asarray(x))
    y_infer = jax.jit(lambda v, x: module.apply(v, x, deterministic=True))(variables,
                                                                            jnp.asarray(x))
    return variables, np.asarray(y_train), _np(mutated["batch_stats"]), np.asarray(y_infer)


@pytest.mark.parametrize("mode", ["training", "inference"])
def test_dense_bn_matches_ku(mode):
    _, specs = _both(DENSE_BN)
    variables, y_train, stats_after, y_infer = _ku_dense_bn()
    x, _ = _inputs((8, 5), seed=2)
    stack = _load(Stack(specs, (8, 5), device=CPU), variables)
    got = stack(torch.from_numpy(x), deterministic=mode == "inference")
    back = variables_from_module(stack)["batch_stats"]
    if mode == "training":
        _close(got, y_train, what="output")
        # flax averages the biased batch variance into the running one.
        _close_trees(back, stats_after, what="batch_stats")
    else:
        _close(got, y_infer, what="output")
        _close_trees(back, variables["batch_stats"], 0.0, "batch_stats")


# -- reversal ------------------------------------------------------------------

ENCODERS = {
    "dense": ([("dense", "e0", dict(units=16, activation="relu")),
               ("dense_bn", "e1", dict(units=8, activation="tanh")),
               ("dense", "e2", dict(units=4))], (3, 20)),
    "conv2d": ([("conv2d", "c0", dict(filters=4, kernel_size=3, strides=2,
                                      activation="relu")),
                ("conv2d", "c1", dict(filters=6, kernel_size=3, strides=2)),
                ("activation", "a", dict(activation="tanh"))], (2, 8, 8, 3)),
    "conv1d_flatten": ([("conv1d", "c0", dict(filters=4, kernel_size=3, strides=2,
                                              activation="relu")),
                        ("conv1d", "c1", dict(filters=5, kernel_size=3)),
                        ("flatten", "f", {}),
                        ("dense", "d", dict(units=6))], (2, 8, 3)),
    "conv3d": ([("conv3d", "c0", dict(filters=3, kernel_size=2, strides=2))],
               (1, 4, 4, 4, 2)),
}


@pytest.mark.parametrize("case", sorted(ENCODERS))
def test_reverse_specs_match_ku(case):
    configs, shape = ENCODERS[case]
    ku_specs, specs = _both(configs)
    want = [s.to_json() for s in ku_ae.reverse_specs(ku_specs, shape)]
    assert [s.to_json() for s in ae.reverse_specs(specs, shape)] == want
    groups = ae.reverse_groups(specs, shape)
    assert [[s.to_json() for s in g] for g in groups] == [
        [s.to_json() for s in g] for g in ku_ae.reverse_groups(ku_specs, shape)]
    for s in ae.reverse_specs(specs, shape) + specs:
        assert LayerSpec.from_json(s.to_json()) == s
        assert hash(LayerSpec.from_json(s.to_json())) == hash(s)


def test_reverse_refuses_what_ku_refuses():
    with pytest.raises(ValueError, match="not reversible"):
        ae.reverse_specs((spec("upsampling2d", "u"),), (1, 2, 2, 1))


def test_spec_json_round_trip():
    s = spec("conv2d", "c", filters=3, kernel_size=[3, 4], strides=(2, 2))
    assert s.cfg["kernel_size"] == (3, 4)
    assert LayerSpec.from_json(s.to_json()) == s
    assert s.with_config(filters=5).cfg["filters"] == 5
    k = ku_spec("conv2d", "c", filters=3, kernel_size=[3, 4], strides=(2, 2))
    assert s.to_json() == k.to_json() and s.config == k.config


@functools.lru_cache(maxsize=None)
def _ku_autoencoder(case, skip):
    configs, shape = ENCODERS[case]
    ku_specs, _ = _both(configs)
    make = ku_ae.make_autoencoder_with_sym_sc if skip else ku_ae.make_autoencoder_from_encoder
    model = make(ku_specs, shape)
    x, _ = _inputs(shape, seed=4)
    out, variables = jax.jit(model.init_with_output)(jax.random.key(4), jnp.asarray(x))
    return _np(variables), np.asarray(out)


# The skip connections concatenate channels, which a flattened code would
# double: ku's reshape refuses it, so the flatten encoder runs plain only.
AE_CASES = [(case, False) for case in sorted(ENCODERS)] + [
    (case, True) for case in sorted(ENCODERS) if case != "conv1d_flatten"]


@pytest.mark.parametrize("case,skip", AE_CASES,
                         ids=[f"{c}-{'sym_skip' if s else 'plain'}" for c, s in AE_CASES])
def test_autoencoder_matches_ku(case, skip):
    configs, shape = ENCODERS[case]
    _, specs = _both(configs)
    variables, want = _ku_autoencoder(case, skip)
    make = ae.make_autoencoder_with_sym_sc if skip else ae.make_autoencoder_from_encoder
    model = _load(make(specs, shape, device=CPU), variables)
    x, _ = _inputs(shape, seed=4)
    _close(model(torch.from_numpy(x)), want, what=case)
    assert model(torch.from_numpy(x)).shape == shape


def test_decoder_from_encoder_is_the_reversal():
    configs, shape = ENCODERS["conv2d"]
    _, specs = _both(configs)
    dec = ae.make_decoder_from_encoder(specs, shape, device=CPU)
    assert dec.specs == ae.reverse_specs(specs, shape)
    assert dec.shapes[0] == infer_shapes(specs, shape)[-1] and dec.output_shape == shape


# -- surgery -----------------------------------------------------------------------

CHAIN = [("dense", f"d{i}", dict(units=6, activation="relu")) for i in range(4)] + [
    ("dense", "out", dict(units=3))]


@pytest.mark.parametrize("where", [
    dict(first_layer_name=None, last_layer_name="d2"),
    dict(first_layer_name="d1", last_layer_name=None),
    dict(first_layer_name="d0", last_layer_name="d3"),
], ids=["head", "tail", "middle"])
def test_glue_layers_matches_ku(where):
    ku_specs, specs = _both(CHAIN)
    new_cfg = [("dense", "n0", dict(units=6)), ("dense", "n1", dict(units=6))]
    ku_new, new = _both(new_cfg)
    got = glue_layers(specs, new, **where)
    want = ku_training.glue_layers(ku_specs, ku_new, **where)
    assert [s.to_json() for s in got] == [s.to_json() for s in want]
    with pytest.raises(ValueError):
        glue_layers(specs, new)


@pytest.mark.parametrize("mode,depth,fixed", [
    (PROGRESSIVE_MODE_FORWARD, 2, ("out",)), (PROGRESSIVE_MODE_FORWARD, 4, ()),
    (PROGRESSIVE_MODE_BACKWARD, 2, ("d0",)), (PROGRESSIVE_MODE_BACKWARD, 1, ())])
def test_create_prog_specs_matches_ku(mode, depth, fixed):
    ku_specs, specs = _both(CHAIN)
    got = create_prog_specs(specs, mode, depth, fixed)
    want = ku_training.create_prog_specs(ku_specs, mode, depth, fixed)
    assert [s.to_json() for s in got] == [s.to_json() for s in want]
    with pytest.raises(ValueError):
        create_prog_specs(specs, 2, depth)


def _mse(y, p):
    return ((y - p) ** 2).mean(axis=-1)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_train_on_batch_prog_model_matches_ku(direction):
    ku_specs, specs = _both(CHAIN)
    x, _ = _inputs((8, 6), seed=5)
    y = np.random.default_rng(6).normal(size=(8, 3)).astype(np.float32)
    params = _np(KuStack(specs=ku_specs).init(jax.random.key(5), jnp.asarray(x))["params"])
    kw = (dict(prog_depth=2, fixed_layer_names=("out",)) if direction == "forward"
          else dict(prog_depth=2, fixed_layer_names=("d0",)))
    ku_fn = getattr(ku_training, f"train_on_batch_{direction}_prog_model")
    port_fn = {"forward": train_on_batch_forward_prog_model,
               "backward": train_on_batch_backward_prog_model}[direction]
    want, want_loss = ku_fn(ku_specs, params, jnp.asarray(x), jnp.asarray(y), _mse, lr=0.1, **kw)
    start = params_from_numpy(params, CPU)
    got, loss = port_fn(specs, start, torch.from_numpy(x), torch.from_numpy(y), _mse, lr=0.1,
                        **kw)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    _close_trees(got, _np(want), what="params")
    kept = {s.name for s in create_prog_specs(
        specs, PROGRESSIVE_MODE_FORWARD if direction == "forward" else PROGRESSIVE_MODE_BACKWARD,
        **kw)}
    for name in start:
        assert (got[name] is start[name]) == (name not in kept), name


def test_select_and_merge_params_are_name_filters():
    _, specs = _both(CHAIN)
    stack = Stack(specs, (2, 6), device=CPU)
    full = param_tree(stack)
    sub = select_params(full, specs[1:3])
    assert sorted(sub) == ["d1", "d2"] and sub["d1"]["kernel"] is stack.d1.kernel
    from ku_torch.engine_ext import merge_params

    merged = merge_params(full, {"d1": {"kernel": torch.zeros(6, 6), "bias": torch.zeros(6)}})
    assert float(merged["d1"]["kernel"].abs().sum()) == 0.0 and merged["d2"] is full["d2"]
    assert full["d1"]["kernel"] is stack.d1.kernel


# -- the batch-statistics Trainer ----------------------------------------------------

FIT_SPECS = [("dense_bn", "bn0", dict(units=16, activation="relu")),
             ("dense_bn", "bn1", dict(units=8, activation="tanh")),
             ("dense", "out", dict(units=4))]
FIT_N, FIT_BATCH, FIT_EPOCHS, ADAM_EPS = 48, 8, 3, 1e-4


def _fit_data():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(FIT_N, 10)).astype(np.float32)
    Y = np.tanh(X[:, :4] * 1.5 + 0.3).astype(np.float32)
    return X, Y


@functools.lru_cache(maxsize=None)
def _ku_fit():
    ku_specs, _ = _both(FIT_SPECS)
    X, Y = _fit_data()
    trainer = KuTrainer(KuStack(specs=ku_specs), _mse, optimizer=optax.adam(1e-3, eps=ADAM_EPS),
                        has_batch_stats=True, seed=3)
    trainer.init(jnp.asarray(X[:1]))
    start = _np({"params": trainer.state["params"], "batch_stats": trainer.state["batch_stats"]})
    history = trainer.fit(X, Y, batch_size=FIT_BATCH, epochs=FIT_EPOCHS, verbose=0)
    test = trainer.test_step(jnp.asarray(X[:16]), jnp.asarray(Y[:16]))["loss"]
    pred = trainer.predict(X, batch_size=20)
    end = _np({"params": trainer.state["params"], "batch_stats": trainer.state["batch_stats"]})
    return start, history, end, test, pred


def test_trainer_with_batch_stats_matches_ku():
    """Adam at eps 1e-4 (ADAM_EPS): the Dense biases that feed a BatchNorm
    have a gradient of 0 in exact arithmetic (BN subtracts the batch mean),
    so at optax's eps 1e-8 Adam would move them by about lr a step on each
    package's own rounding noise, and the running means with them."""
    _, specs = _both(FIT_SPECS)
    X, Y = _fit_data()
    start, want_hist, end, want_test, want_pred = _ku_fit()
    model = _load(Stack(specs, (FIT_BATCH, 10), device=CPU), start)
    trainer = Trainer(model, lambda y, p: ((y - p) ** 2).mean(dim=-1),
                      optimizer=adam(1e-3, eps=ADAM_EPS), has_batch_stats=True, seed=3)
    history = trainer.fit(X, Y, batch_size=FIT_BATCH, epochs=FIT_EPOCHS, verbose=0)
    np.testing.assert_allclose(history, want_hist, rtol=1e-4)
    got = variables_from_module(model)
    for what in ("params", "batch_stats"):
        flat_got = jax.tree_util.tree_leaves_with_path(got[what])
        flat_want = dict(jax.tree_util.tree_leaves_with_path(end[what]))
        assert len(flat_got) == len(flat_want)
        for path, value in flat_got:
            np.testing.assert_allclose(value, flat_want[path], rtol=0, atol=1e-5,
                                       err_msg=f"{what} {jax.tree_util.keystr(path)}")
    # test_step and predict read the running statistics and leave them.
    stats = {k: v.clone() for k, v in model.named_buffers()}
    assert abs(trainer.test_step(X[:16], Y[:16])["loss"] - want_test) <= 1e-4 * want_test
    np.testing.assert_allclose(trainer.predict(X, batch_size=20), want_pred, rtol=0, atol=1e-5)
    for k, v in model.named_buffers():
        assert torch.equal(v, stats[k]), k
