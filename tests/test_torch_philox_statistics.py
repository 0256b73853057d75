"""Statistics of the port's Philox draws, the counterpart of the TPU's
hardware PRNG (tests_tpu/test_tpu_regression.py:18-64), on the CPU.

The CD kernel and its plain version draw the same Philox4x32-10 words
(``ku_torch.core.rng.philox_uniforms``); Gaussian-mode sampling turns two of
them into a normal by Box-Muller (``box_muller``). Same statistics and limits
as the TPU's test: uniforms in [0, 1), mean within 0.01 of 1/2, variance
within 0.005 of 1/12, every column spread (std > 0.2); normals with mean
within 0.02 of 0, std within 0.02 of 1, all finite. (1024, 128) draws, at
the TPU test's seeds and two more, and at a later step.
"""

import numpy as np
import pytest

from ku_torch.core.rng import box_muller, philox_uniforms


@pytest.mark.parametrize("seed,step", [(1234, 0), (99, 0), (7, 1406)])
def test_philox_uniform_statistics(seed, step):
    u = philox_uniforms(seed, step, 1, 1024, 128)[0].numpy()
    assert u.shape == (1024, 128)
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.01
    assert abs(u.var() - 1.0 / 12.0) < 0.005
    assert (u.std(axis=0) > 0.2).all()  # no stuck column


@pytest.mark.parametrize("seed,step", [(99, 0), (1234, 0), (7, 1406)])
def test_box_muller_normal_statistics(seed, step):
    u = philox_uniforms(seed, step, 2, 1024, 128)
    z = box_muller(u[0], u[1]).numpy()
    assert np.isfinite(z).all()
    assert abs(z.mean()) < 0.02
    assert abs(z.std() - 1.0) < 0.02
