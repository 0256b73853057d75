"""What decides ``correct`` fails where it must: each fault a training cell
can have, planted under a run on the CPU, turns ``correct`` false; the
control (the reference itself, its products in TF32) fails the limits at
the cells' widths; a sound run passes. At a test's size: 384 rows, three
batches of 128 in the RBM cell, four of 100 in the DBN cell (the last
padded)."""

import time

import pytest
import torch

from kubench.harness import compare, main, spec, traffic as tf

SMALL = {"kind": "bernoulli_rows", "rows": 384, "density": 0.13, "hps": {"k": 1}}
CPU = torch.device("cpu")
CASES = [(cell, f) for cell in ("rbm_mnist.cd1", "dbn_hinton06.cd1")
         for f in spec.load_cell(cell).driver().FAULTS]


def run(cell, seed=2**31 + 11):
    return main.run_cell(cell, seed, 0.2, False, time.perf_counter(), device=CPU, traffic=SMALL)


@pytest.mark.parametrize("cell", ["rbm_mnist.cd1", "dbn_hinton06.cd1"])
def test_the_cd_cells_compare_scores_and_changes(cell):
    assert set(spec.load_cell(cell).config["limits"]) >= {"loss_gap", "delta_gap"}


@pytest.mark.parametrize("cell", ["rbm_mnist.cd1", "dbn_hinton06.cd1"])
def test_a_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", CASES)
def test_each_fault_reads_false(cell, fault):
    with spec.load_cell(cell).driver().fault(fault):
        result = run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", ["rbm_mnist.cd1", "dbn_hinton06.cd1"])
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_the_control_reads_false(cell, seed):
    c = spec.load_cell(cell)
    driver = c.driver().Driver(torch, c.config, SMALL, seed, CPU, False)
    values, _ = driver.check(driver.control(tf.job_seed(seed, 0)))
    ok, checks = compare.verdict(values, c.config["limits"])
    assert not ok, checks
