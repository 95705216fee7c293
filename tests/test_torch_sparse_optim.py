"""Port's in-table sparse optimizers (plain PyTorch) vs the JAX package's
``ops/sparse_optim.py`` on the same numpy inputs.

Tolerance rtol=1e-6, atol=1e-7: the same float32 formulas; a pow, a sqrt
or a mean may round differently in the last bit."""

import numpy as np
import pytest
import torch

from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.ops import sparse_optim as jax_optim
from paddlebox_tpu_torch.config import TableConfig
from paddlebox_tpu_torch.ops import sparse_optim

TOL = dict(rtol=1e-6, atol=1e-7)


def inputs(seed, conf, n, d):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, d)).astype(np.float32) * 0.1
    g = rng.normal(size=(n, d)).astype(np.float32) * 0.05
    width = sparse_optim.state_width(conf, d)
    state = rng.uniform(0.0, 2.0, size=(n, width)).astype(np.float32)
    if conf.optimizer == "adam":
        state[:, 0] = rng.integers(0, 6, size=n)   # per-row step count t
    mask = rng.uniform(size=n) < 0.7
    return w, g, state, mask


@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_apply_update_matches_jax(optimizer, d):
    kw = dict(optimizer=optimizer, learning_rate=0.05, initial_g2sum=3.0)
    conf, jconf = TableConfig(**kw), JaxTableConfig(**kw)
    w, g, state, mask = inputs(0, conf, 64, d)
    got_w, got_s = sparse_optim.apply_update(
        conf, torch.from_numpy(w), torch.from_numpy(g),
        torch.from_numpy(state), torch.from_numpy(mask))
    want_w, want_s = jax_optim.apply_update(jconf, w, g, state, mask)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    # masked rows keep w AND state exactly
    np.testing.assert_array_equal(got_w.numpy()[~mask], w[~mask])
    np.testing.assert_array_equal(got_s.numpy()[~mask], state[~mask])
    assert not np.array_equal(got_w.numpy()[mask], w[mask])


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_state_width_matches_jax(optimizer):
    for d in (1, 4, 8):
        assert sparse_optim.state_width(TableConfig(optimizer=optimizer),
                                        d) == jax_optim.state_width(
            JaxTableConfig(optimizer=optimizer), d)


def test_adagrad_scale_uses_the_old_g2sum():
    conf = TableConfig(optimizer="adagrad", learning_rate=1.0,
                       initial_g2sum=3.0)
    w = torch.zeros(1, 2)
    g = torch.ones(1, 2)
    new_w, new_s = sparse_optim.apply_update(conf, w, g,
                                             torch.tensor([[1.0]]),
                                             torch.tensor([True]))
    assert new_w[0, 0].item() == pytest.approx(-np.sqrt(3.0 / 4.0))
    assert new_s.item() == 2.0


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown sparse optimizer"):
        sparse_optim.state_width(TableConfig(optimizer="ftrl"), 4)
