"""The port's transformer examples (examples_torch/transformer) against ku's
(examples/transformer), on the CPU, mirroring tests/test_example_transformer
.py's five tests at its shrunken sizes: the classification dataset, the
training pipeline, flash against plain logits, the generation example's
pipeline (trained from ku's initial weights, its greedy accuracy within
0.05 of ku's) and the open-loop server.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from examples_torch.transformer import transformer_classify as port_classify
from examples_torch.transformer import transformer_generate as port_generate
from examples_torch.transformer.transformer_server import simulate
from ku_torch.engine_ext import Trainer, adam
from ku_torch.nn import generate
from ku_torch.utility import state_dict_from_tree

_XDIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "examples", "transformer")


def _ku_example(name):
    sys.path.insert(0, _XDIR)
    try:
        return __import__(name)
    finally:
        sys.path.remove(_XDIR)


def _load(module, params, embed_name):
    """ku's params into the port's module (flax's Embed table is
    ``<name>/embedding``, torch's ``<name>.weight``)."""
    sd = state_dict_from_tree(params, "cpu")
    sd[f"{embed_name}.weight"] = sd.pop(f"{embed_name}.embedding")
    module.load_state_dict(sd, strict=True)
    return module


def test_dataset_labels_correct_and_equal_to_ku():
    x, y = port_classify.make_dataset(512, 16, 24, seed=3)
    recheck = np.array([(row[1:] == row[0]).any() for row in x], np.int32)
    np.testing.assert_array_equal(y, recheck)
    assert 0.4 < y.mean() < 0.6  # balanced
    kx, ky = _ku_example("transformer_classify").make_dataset(512, 16, 24, seed=3)
    np.testing.assert_array_equal(x, kx)
    np.testing.assert_array_equal(y, ky)
    np.testing.assert_array_equal(
        port_generate.make_dataset(64, 13, 4, 8, seed=2),
        _ku_example("transformer_generate").make_dataset(64, 13, 4, 8, seed=2))


def test_training_pipeline_runs_and_improves():
    x, y = port_classify.make_dataset(2048, 12, 16, seed=0)
    model = port_classify.TransformerClassifier(vocab=16, seq_len=12, d_model=32,
                                                num_head=4, num_blocks=1, device="cpu")
    tr = Trainer(model, port_classify.softmax_xent, optimizer=adam(1e-3),
                 rng_streams=("dropout",))
    h = tr.fit(x, y, batch_size=128, epochs=3, verbose=0)
    assert np.isfinite(h).all() and h[-1] < h[0]
    logits = tr.predict(x[:64])
    assert logits.shape == (64, 2)


def test_flash_path_matches_plain_and_ku():
    """use_flash=True (the flash kernels' plain versions here) gives the
    plain path's logits for the same weights, ku's initial weights, and
    both equal ku's logits."""
    ku_mod = _ku_example("transformer_classify")
    x, _ = port_classify.make_dataset(8, 16, 16, seed=1)
    kw = dict(vocab=16, seq_len=16, d_model=32, num_head=2, num_blocks=1)
    ku_plain = ku_mod.TransformerClassifier(**kw, use_flash=False)
    variables = jax.jit(ku_plain.init)(jax.random.key(0), x)
    want = np.asarray(jax.jit(ku_plain.apply)(variables, x))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        plain, flash = (_load(port_classify.TransformerClassifier(
            **kw, use_flash=f, device="cpu"), variables["params"], "embed")(xt).numpy()
            for f in (False, True))
    np.testing.assert_allclose(flash, plain, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(plain, want, rtol=2e-4, atol=2e-5)


def test_generate_example_pipeline_tracks_ku():
    """The generation example at toy scale: ku's LM trained by ku's
    Trainer, and the port's LM from the same initial weights by the port's,
    10 epochs each; greedy generation beats chance decisively in both and
    the port's accuracy lies within 0.05 of ku's."""
    from ku.engine_ext import Trainer as KuTrainer
    from ku.nn import generate as ku_generate

    ku_gen = _ku_example("transformer_generate")
    vocab, seq_len, period = 8, 12, 4
    seqs = port_generate.make_dataset(2048, seq_len + 1, period, vocab, seed=0)
    x, y = seqs[:, :-1], seqs[:, 1:]
    arch = dict(vocab=vocab, seq_len=seq_len, d_model=32, num_head=2, num_blocks=2)

    def masked_xent(y_true, logits):
        oh = jax.nn.one_hot(jnp.asarray(y_true, jnp.int32), vocab)
        ce = optax.softmax_cross_entropy(logits, oh)
        mask = (jnp.arange(ce.shape[1]) >= period - 1)[None, :]
        return (ce * mask).sum(1) / mask.sum()

    ku_tr = KuTrainer(ku_gen.LM(**arch), masked_xent, optimizer=optax.adam(2e-3))
    ku_tr.init(jnp.asarray(x[:1]))
    port = _load(port_generate.LM(**arch, device="cpu"), ku_tr.state["params"], "tok")
    assert np.isfinite(ku_tr.fit(x, y, batch_size=128, epochs=10, verbose=0)).all()
    tr = Trainer(port, port_generate.masked_xent(period), optimizer=adam(2e-3))
    assert np.isfinite(tr.fit(x, y, batch_size=128, epochs=10, verbose=0)).all()

    test = port_generate.make_dataset(128, seq_len, period, vocab, seed=1)
    half = seq_len // 2
    params = ku_tr.state["params"]
    table, pos_table = params["tok"]["embedding"], params["pos"]
    core = ku_gen.LMCore(32, 2, 2, max_decode_len=seq_len)
    want = np.asarray(jax.jit(lambda p, i: ku_generate(
        core, p, i, seq_len - half, embed=lambda t, q: table[t] + pos_table[q][None],
        readout=lambda yy: yy @ table.T))(params["core"], jnp.asarray(test[:, :half])))
    ku_acc = float((want == test[:, half:]).mean())

    embed, readout = port_generate.hooks(port.eval(), seq_len)
    core_t = port_generate.serving_core(port, arch, "cpu", max_decode_len=seq_len)
    got = generate(core_t, torch.from_numpy(test[:, :half]), seq_len - half,
                   embed=embed, readout=readout).numpy()
    acc = float((got == test[:, half:]).mean())
    assert ku_acc > 0.6 and acc > 0.6, (ku_acc, acc)  # chance is 1/8
    assert abs(acc - ku_acc) <= 0.05, (acc, ku_acc)


def test_server_simulation_completes():
    """The online-serving demo (open-loop arrivals through the paged slot
    pool) completes a small workload with sane scheduling stats."""
    r = simulate(num_requests=6, num_slots=2, vocab=13, d_model=16, num_head=2,
                 prompt_len=4, max_decode_len=48, chunk=3, page=8, verbose=False,
                 device="cpu")
    assert r["requests"] == 6
    assert r["generated_tokens"] > 0
    assert r["prefill_rounds"] >= r["admissions"]
    assert 0 < r["peak_pages_in_use"] <= r["pool_pages"]
    assert 0 < r["slot_utilization"] <= 1
