"""Port's host-table step (``paddlebox_tpu_torch/trainer/train_step.py``
``TrainStep.__call__``) against the JAX package's ``TrainStep``: each
package's ``EmbeddingTable(backend="numpy")`` pulls the batch, the step
runs on it and the table pushes its ``demb``, for 3 steps, from the same
dense weights (the reference's flax params, converted) and the same table
init (``key_init_uniform``, a function of the key).

Tolerances: loss, preds, demb, every row by key, the dense params and the
AUC state rtol 1e-5, atol 1e-6 (float32 GEMMs in another order); demb's
show/clk columns and the rows' show/clk exact (counts). Under the adam
dense optimizer, the few weights whose gradient stayed near adam's eps are
held within a tenth of the learning rate (``adam_calm``)."""

import jax
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.config import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.models import FeedDNN as FlaxFeedDNN
from paddlebox_tpu.models import MMoE as FlaxMMoE
from paddlebox_tpu.models import WideDeep as FlaxWideDeep
from paddlebox_tpu.ps.table import EmbeddingTable as JaxTable
from paddlebox_tpu.trainer.train_step import TrainStep as JaxTrainStep
from paddlebox_tpu_torch.config import TableConfig, TrainerConfig
from paddlebox_tpu_torch.models import DeepFM
from paddlebox_tpu_torch.models.convert import (flax_leaves_from_model,
                                                model_from_flax_leaves)
from paddlebox_tpu_torch.ops import seqpool_kernel
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.trainer.train_step import TrainStep

B, S, NPAD, DD = 16, 4, 160, 3
STEPS = 3
BUCKETS = 4096
RTOL, ATOL = 1e-5, 1e-6
MODELS = {
    "DeepFM": (FlaxDeepFM, dict(hidden=(16,))),
    "WideDeep": (FlaxWideDeep, dict(hidden=(16, 8))),
    "MMoE": (FlaxMMoE, dict(num_tasks=2, num_experts=3, expert_hidden=(16,),
                            expert_out=8, tower_hidden=(8,))),
    "FeedDNN": (FlaxFeedDNN, dict(hidden=(32, 16))),
}


def table_kw(optimizer):
    return dict(embedx_dim=4, cvm_offset=3, optimizer=optimizer,
                learning_rate=0.05, embedx_threshold=1.0,
                initial_range=0.05, seed=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """JAX's CPU thread pools spin beside torch's intra-op threads and slow
    these small torch ops several times over; one thread is enough."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batches(seed, tasks):
    """STEPS batches of B rows of S slots with 0-3 keys each (padding key
    0, segment B*S), 3 dense values, labels [B] or [B, tasks], the last
    two rows masked."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        lengths = rng.integers(0, 4, size=B * S)
        n = int(lengths.sum())
        keys = np.zeros(NPAD, np.uint64)
        keys[:n] = rng.integers(1, 60, size=n)
        segs = np.full(NPAD, B * S, np.int32)
        segs[:n] = np.repeat(np.arange(B * S), lengths)
        labels = rng.integers(0, 2, size=(B, tasks)).astype(np.float32)
        click = labels[:, 0].copy()
        labels = labels if tasks > 1 else click
        cvm = np.stack([np.ones(B, np.float32), click], axis=1)
        dense = rng.normal(size=(B, DD)).astype(np.float32)
        mask = np.ones(B, np.float32)
        mask[-2:] = 0.0
        out.append((keys, segs, cvm, labels, dense, mask))
    return out


def rows_by_key(table):
    snap = table.snapshot(reset_dirty=False)
    order = np.argsort(snap["keys"])
    return [snap[k][order] for k in ("keys", "values", "state",
                                     "embedx_ok")]


def adam_calm(nus):
    """For each dense leaf, where adam was well conditioned at every step:
    the gradient's RMS (the reference's bias-corrected ``nu`` after step
    ``t``, ``nus[t - 1]``) zero or at least ten times adam's eps 1e-8.
    Between, a near-zero grad (a float32 cancellation, a relative error
    of a few percent between the packages) sets the step
    ``lr * g / (|g| + eps)``, whose change is up to a quarter of that
    relative error times ``lr``; such elements (at most 1%) are held
    within ``0.1 * lr``."""
    calm = None
    for t, nu in enumerate(nus, 1):
        ok = [(v == 0) | (np.sqrt(v / (1 - 0.999 ** t)) >= 1e-7)
              for v in nu]
        calm = ok if calm is None else [a & b for a, b in zip(calm, ok)]
    return calm


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_steps_match_reference(kind, optimizer):
    flax_cls, kw = MODELS[kind]
    jconf, pconf = (JaxTableConfig(**table_kw(optimizer)),
                    TableConfig(**table_kw(optimizer)))
    tkw = dict(dense_optimizer=optimizer, dense_learning_rate=0.01)
    jstep = JaxTrainStep(flax_cls(**kw), jconf, JaxTrainerConfig(**tkw), B,
                         S, DD, num_auc_buckets=BUCKETS)
    jparams, jopt = jstep.init(jax.random.PRNGKey(0))
    jauc = jstep.init_auc_state()
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jparams)]
    model = model_from_flax_leaves(kind, kw, leaves,
                                   S * pconf.pull_dim + DD)
    step = TrainStep(model, pconf, TrainerConfig(**tkw), B, S, DD,
                     num_auc_buckets=BUCKETS, device="cpu")
    params, opt = step.init()
    auc = step.init_auc_state()
    jt, pt = JaxTable(jconf, backend="numpy"), EmbeddingTable(
        pconf, backend="numpy")
    tasks = kw.get("num_tasks", 1)
    seqpool_kernel.seqpool_cvm_cuda.launches = 0
    nus = []
    for keys, segs, cvm, labels, dense, mask in batches(1, tasks):
        jemb, emb = jt.pull(keys), pt.pull(keys)
        np.testing.assert_array_equal(emb[:, :2], jemb[:, :2])
        close(emb, jemb, "pull")
        (jparams, jopt, jauc, jdemb, jloss, jpreds) = jstep(
            jparams, jopt, jauc, jemb, segs, cvm, labels, dense, mask)
        params, opt, auc, demb, loss, preds = step(
            params, opt, auc, emb, segs, cvm, labels, dense, mask)
        jdemb = np.asarray(jdemb)
        if optimizer == "adam":     # host copies: the step donates them
            nus.append([np.asarray(v) for v in
                        jax.tree_util.tree_leaves(jopt[0].nu)])
        assert isinstance(demb, np.ndarray) and demb.dtype == np.float32
        assert demb.shape == jdemb.shape == (NPAD, pconf.pull_dim)
        # the show/clk channel the push reads: cvm_in per key, 0 padding
        np.testing.assert_array_equal(demb[:, :2], jdemb[:, :2])
        close(demb, jdemb, "demb")
        close(float(loss), float(jloss), "loss")
        assert preds.shape == np.shape(jpreds)
        close(preds.numpy(), jpreds, "preds")
        jt.push(keys, jdemb)
        pt.push(keys, demb)
    got, want = rows_by_key(pt), rows_by_key(jt)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1][:, :2], want[1][:, :2])
    np.testing.assert_array_equal(got[3], want[3])
    close(got[1], want[1], "values")
    close(got[2], want[2], "state")
    jleaves = jax.tree_util.tree_leaves(jparams)
    calm = adam_calm(nus) if optimizer == "adam" else None
    for i, (a, b) in enumerate(zip(flax_leaves_from_model(params),
                                   jleaves)):
        b = np.asarray(b)
        if calm is None:
            close(a, b, "dense params")
            continue
        close(a[calm[i]], b[calm[i]], "dense params")
        np.testing.assert_allclose(a[~calm[i]], b[~calm[i]], rtol=0,
                                   atol=0.1 * tkw["dense_learning_rate"])
    if calm is not None:
        n = sum(c.size for c in calm)
        assert sum(int((~c).sum()) for c in calm) <= n // 100
    for f in jauc:
        close(auc[f].numpy(), jauc[f], f"auc {f}")
    assert float(auc["count"]) == STEPS * (B - 2)
    assert seqpool_kernel.seqpool_cvm_cuda.launches == 0


def test_predict_matches_reference():
    """The forward alone, from host arrays, for a multi-task model."""
    flax_cls, kw = MODELS["MMoE"]
    jconf, pconf = JaxTableConfig(**table_kw("adagrad")), TableConfig(
        **table_kw("adagrad"))
    jstep = JaxTrainStep(flax_cls(**kw), jconf, JaxTrainerConfig(), B, S,
                         DD)
    jparams, _ = jstep.init(jax.random.PRNGKey(1))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jparams)]
    step = TrainStep(model_from_flax_leaves("MMoE", kw, leaves,
                                            S * pconf.pull_dim + DD),
                     pconf, TrainerConfig(), B, S, DD, device="cpu")
    keys, segs, cvm, _, dense, _ = batches(2, 2)[0]
    emb = EmbeddingTable(pconf, backend="numpy").pull(keys)
    got = step.predict(step.init()[0], emb, segs, cvm, dense).numpy()
    want = np.asarray(jstep.predict(jparams, emb, segs, cvm, dense))
    assert got.shape == want.shape == (B, 2)
    close(got, want, "preds")


@pytest.mark.parametrize("conf,item", [
    (dict(bf16=True, recompute=True), "A.2"), (dict(recompute=True), "A.2"),
    (dict(dense_optimizer="lars"), "A.2"),
    (dict(dense_optimizer="lamb"), "A.2"),
    (dict(grad_merge_steps=2), "A.2")])
def test_unported_options_refused(conf, item):
    """The options ROADMAP ``item`` once held (recompute, lars, lamb,
    gradient merging) are ported: the step builds and trains one step on
    the CPU, its loss finite and its params changed.
    ``tests/test_torch_dense_optim.py`` holds them to the reference."""
    pconf = TableConfig(**table_kw("adagrad"))
    torch.manual_seed(0)
    model = DeepFM(S * pconf.pull_dim + DD, (8,))
    step = TrainStep(model, pconf, TrainerConfig(**conf), B, S, DD,
                     device="cpu")
    assert step.recompute == conf.get("recompute", False)
    params, opt = step.init()
    before = [p.detach().clone() for p in params.parameters()]
    keys, segs, cvm, labels, dense, mask = batches(5, 1)[0]
    emb = EmbeddingTable(pconf, backend="numpy").pull(keys)
    for _ in range(conf.get("grad_merge_steps", 1)):
        params, opt, _, demb, loss, _ = step(
            params, opt, step.init_auc_state(), emb, segs, cvm, labels,
            dense, mask)
    assert np.isfinite(float(loss)) and np.isfinite(demb).all()
    assert any(not torch.equal(a, b) for a, b in
               zip(before, params.parameters()))


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainStep(torch.nn.Linear(1, 1), TableConfig(), TrainerConfig(), B,
                  S)
