"""Port's ``MetricRegistry`` (``paddlebox_tpu_torch/metrics/registry.py``)
against the JAX package's over the same predictions, labels, cmatch, rank
and masks: the masks each entry selects exactly; of ``get_metric_msg``,
the metrics of the histograms and the 0/1 sums (auc, bucket_error,
actual_ctr, ins_num) within 1e-12 (both add float32 increments into
float64), those of the float32 sums of predictions (mae, rmse,
predicted_ctr) within rtol 1e-6, as ``test_torch_auc.py`` holds them (a
batch's reduction runs in another order)."""

import numpy as np
import pytest

from paddlebox_tpu.metrics.registry import MetricRegistry as JaxRegistry
from paddlebox_tpu_torch.metrics import MetricRegistry

ENTRIES = {
    "ctr_auc": dict(num_buckets=1 << 12),
    "cvr_auc": dict(label="cvr", pred="p1", num_buckets=1 << 10),
    "pair": dict(cmatch_rank=[(222, 1), (223, 2)], phase=1,
                 num_buckets=1 << 12),
    "cmatch_only": dict(cmatch_rank=[(222, 0)], ignore_rank=True, phase=0,
                        num_buckets=1 << 12),
}

FLOAT_SUMS = ("mae", "rmse", "predicted_ctr")


def batch(rng, n):
    return dict(preds=rng.uniform(size=n).astype(np.float32),
                labels=(rng.uniform(size=n) < 0.3).astype(np.float32),
                cmatch=rng.choice([222, 223, 224], size=n),
                rank=rng.integers(0, 3, size=n),
                mask=(rng.uniform(size=n) < 0.9).astype(np.float32))


def registries():
    regs = JaxRegistry(), MetricRegistry()
    for reg in regs:
        for name, kw in ENTRIES.items():
            reg.init_metric(name, **kw)
    return regs


def feed(reg, b, with_rank=True, with_mask=True):
    for name in reg.names():
        reg[name].add(b["preds"], b["labels"], cmatch=b["cmatch"],
                      rank=b["rank"] if with_rank else None,
                      mask=b["mask"] if with_mask else None)


def assert_same_metrics(jreg, preg):
    assert jreg.names() == preg.names()
    for name in jreg.names():
        want, got = jreg.get_metric_msg(name), preg.get_metric_msg(name)
        assert set(got) == set(want)
        for k in want:
            tol = 1e-6 if k in FLOAT_SUMS else 1e-12
            np.testing.assert_allclose(got[k], want[k], rtol=tol,
                                       atol=1e-12, err_msg=f"{name} {k}")


@pytest.mark.parametrize("with_rank,with_mask", [
    (True, True), (False, True), (True, False)])
def test_metrics_match_reference(with_rank, with_mask):
    jreg, preg = registries()
    rng = np.random.default_rng(3)
    for _ in range(4):
        b = batch(rng, 500)
        feed(jreg, b, with_rank, with_mask)
        feed(preg, b, with_rank, with_mask)
        for name in ENTRIES:
            np.testing.assert_array_equal(
                preg[name].select_mask(b["cmatch"], b["rank"], b["mask"],
                                       500),
                jreg[name].select_mask(b["cmatch"], b["rank"], b["mask"],
                                       500))
    assert_same_metrics(jreg, preg)
    assert preg.get_metric_msg("ctr_auc")["ins_num"] > \
        preg.get_metric_msg("pair")["ins_num"] > 0


def test_phases_and_reset_match_reference():
    jreg, preg = registries()
    for phase in (-1, 0, 1, 2):
        assert preg.names(phase) == jreg.names(phase)
    b = batch(np.random.default_rng(5), 300)
    feed(jreg, b)
    feed(preg, b)
    jreg.reset(phase=1)
    preg.reset(phase=1)
    assert_same_metrics(jreg, preg)
    assert preg.get_metric_msg("pair")["ins_num"] == 0
    assert preg.get_metric_msg("cmatch_only")["ins_num"] > 0
    assert preg["cvr_auc"].label == "cvr" and preg["cvr_auc"].pred == "p1"
