"""The port's RBM examples (examples_torch/rbm) and MNIST loader against
ku's (examples/rbm, examples/common.py), on the CPU over sklearn's digits.

- The loader: the digits' 8→28 upscale through the port's own linear
  resize against ``jax.image.resize`` in ``common.load_mnist``, within 1e-3
  on the 0–255 scale; and a Kaggle ``train.csv`` read by both.
- ``MNISTClassifier`` writes ``solution.csv`` (1,797 rows and the header)
  under ``tmp_path``, and its training-set accuracy lies within 0.05 of
  ku's example on the same data, measured here (the draws differ: torch's
  generators against JAX's threefry). The saved model loads back with
  ``model_loading``.
- The DBN example's classifier (one pretraining epoch) writes its
  ``solution.csv``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from examples_torch import common as tcommon
from examples_torch.rbm import dbn_mnist, rbm_softmax_mnist
from ku_torch.core.config import load_config

_KU_RBM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "examples", "rbm")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one torch thread is faster here and spares the other
    test workers the oversubscribed cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ku_example():
    sys.path.insert(0, _KU_RBM)
    try:
        import rbm_softmax_mnist as ku_rbm_softmax  # noqa: PLC0415
        import common as ku_common  # noqa: PLC0415  (put on sys.path by the example)
    finally:
        sys.path.remove(_KU_RBM)
    return ku_rbm_softmax, ku_common


def _solution(path):
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "ImageId,Label"
    rows = [line.split(",") for line in lines[1:]]
    assert [int(r[0]) for r in rows] == list(range(1, len(rows) + 1))
    labels = np.array([int(r[1]) for r in rows])
    assert labels.min() >= 0 and labels.max() <= 9
    return labels


@pytest.mark.parametrize("flatten", [True, False])
def test_loader_matches_ku_on_the_digits(tmp_path, flatten):
    _, ku_common = _ku_example()
    V, y = tcommon.load_mnist(flatten=flatten, data_dir=str(tmp_path))
    V_ku, y_ku = ku_common.load_mnist(flatten=flatten, data_dir=str(tmp_path))
    assert V.shape == V_ku.shape and V.dtype == np.float32
    np.testing.assert_allclose(V, V_ku, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(y, y_ku)


def test_loader_reads_kaggle_csv(tmp_path):
    _, ku_common = _ku_example()
    rng = np.random.default_rng(0)
    table = np.concatenate([rng.integers(0, 10, (5, 1)), rng.integers(0, 256, (5, 784))], 1)
    header = "label," + ",".join(f"pixel{i}" for i in range(784))
    np.savetxt(tmp_path / "train.csv", table, fmt="%d", delimiter=",", header=header,
               comments="")
    for flatten in (True, False):
        V, y = tcommon.load_mnist(flatten=flatten, data_dir=str(tmp_path))
        V_ku, y_ku = ku_common.load_mnist(flatten=flatten, data_dir=str(tmp_path))
        np.testing.assert_array_equal(V, V_ku)
        np.testing.assert_array_equal(y, y_ku)


def test_rbm_softmax_classifier_writes_solution(tmp_path, monkeypatch):
    ku_example, ku_common = _ku_example()
    V, gt = tcommon.load_mnist(data_dir=str(tmp_path))
    conf = load_config(rbm_softmax_mnist.CONF_PATH)

    mc = rbm_softmax_mnist.MNISTClassifier(conf, device="cpu", model_dir=str(tmp_path))
    mc.train(V, gt)
    res = mc.test(V, out_path=str(tmp_path / "solution.csv"))
    labels = _solution(tmp_path / "solution.csv")
    assert labels.shape == (1797,)
    np.testing.assert_array_equal(labels, np.argmax(res, -1))
    acc = float((labels == gt).mean())

    loaded = rbm_softmax_mnist.MNISTClassifier(dict(conf, model_loading=True), device="cpu",
                                               model_dir=str(tmp_path))
    np.testing.assert_allclose(loaded.test(V, out_path=str(tmp_path / "again.csv")), res,
                               rtol=1e-6, atol=1e-7)

    # ku's example on the same data; it saves its model to the working dir.
    monkeypatch.chdir(tmp_path)
    ku_mc = ku_example.MNISTClassifier(conf)
    ku_mc.train(V, gt)
    ku_res = ku_mc.test(V, out_path=str(tmp_path / "ku_solution.csv"))
    ku_acc = float((np.argmax(ku_res, -1) == gt).mean())
    assert abs(acc - ku_acc) <= 0.05, (acc, ku_acc)


def test_dbn_classifier_writes_solution(tmp_path, monkeypatch):
    monkeypatch.setitem(dbn_mnist.HPS, "epochs", 1)  # one pretraining epoch a layer
    V, gt = tcommon.load_mnist(data_dir=str(tmp_path))
    mc = dbn_mnist.MNISTClassifier(device="cpu")
    mc.train(V, gt)
    mc.test(V, out_path=str(tmp_path / "solution.csv"))
    labels = _solution(tmp_path / "solution.csv")
    assert labels.shape == (1797,)
    assert float((labels == gt).mean()) > 0.5
