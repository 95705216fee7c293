"""Port's AUC (device-tier ``auc_update`` in PyTorch, host-tier
``AucCalculator`` in numpy float64) vs the JAX package's, on the same
numpy predictions.

Histograms and counts must be equal (0/1 weights add exactly); the float
sums within rtol 1e-6 (float32 reductions in another order)."""

import numpy as np
import pytest
import torch

from paddlebox_tpu.metrics.auc import AucCalculator as JaxAuc
from paddlebox_tpu.metrics.auc import auc_update as jax_update
from paddlebox_tpu.metrics.auc import new_auc_state as jax_state
from paddlebox_tpu_torch.metrics.auc import (AUC_NUM_BUCKETS, AucCalculator,
                                             auc_update, new_auc_state)


def batches(seed, n, B):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        labels = (rng.uniform(size=B) < 0.3).astype(np.float32)
        preds = np.clip(rng.normal(0.3 + 0.3 * labels, 0.2), -0.1,
                        1.1).astype(np.float32)
        mask = (rng.uniform(size=B) < 0.9).astype(np.float32)
        yield preds, labels, mask


@pytest.mark.parametrize("buckets", [1 << 10, 1 << 16])
def test_auc_update_matches_jax(buckets):
    st = new_auc_state(buckets, "cpu")
    jst = jax_state(buckets)
    for preds, labels, mask in batches(0, 3, 256):
        st = auc_update(st, *(torch.from_numpy(x)
                              for x in (preds, labels, mask)))
        jst = jax_update(jst, preds, labels, mask)
    for f in ("pos", "neg", "count"):
        np.testing.assert_array_equal(st[f].numpy(), np.asarray(jst[f]))
    for f in ("abs_err", "sq_err", "pred_sum", "label_sum"):
        np.testing.assert_allclose(float(st[f]), float(jst[f]), rtol=1e-6)


def test_calculator_matches_jax():
    calc, jcalc = AucCalculator(1 << 12), JaxAuc(1 << 12)
    for preds, labels, mask in batches(1, 4, 512):
        calc.add_batch(preds, labels, mask)
        jcalc.add_batch(preds, labels, mask)
    calc.add_batch(np.array([0.2, 0.9], np.float32),
                   np.array([0.0, 1.0], np.float32))
    jcalc.add_batch(np.array([0.2, 0.9], np.float32),
                    np.array([0.0, 1.0], np.float32))
    got, want = calc.compute(), jcalc.compute()
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-9), k
    assert 0.5 < got["auc"] < 1.0


def test_absorb_drains_the_device_state():
    st = new_auc_state(64, "cpu")
    for preds, labels, mask in batches(2, 2, 128):
        auc_update(st, torch.from_numpy(preds), torch.from_numpy(labels),
                   torch.from_numpy(mask))
    calc = AucCalculator(64)
    calc.absorb(st)
    calc.absorb(st)
    assert calc.pos.dtype == np.float64
    np.testing.assert_array_equal(calc.pos, 2 * st["pos"].numpy())
    assert calc.sums["count"] == 2 * float(st["count"])


def test_default_bucket_count_is_the_flag_default():
    from paddlebox_tpu import flags
    assert AUC_NUM_BUCKETS == flags.get("auc_num_buckets")
    assert AucCalculator().num_buckets == AUC_NUM_BUCKETS
