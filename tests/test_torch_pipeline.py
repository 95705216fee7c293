"""The port's GPipe pipeline (``paddlebox_tpu_torch/parallel/
pipeline.py``) over a CPU ``pp`` mesh of 4 stages, against the
reference's (its 4 virtual devices; the tower's flax params converted):

- ``make_pipeline`` against the stages applied in order and the
  reference's pipeline (rtol 1e-5, atol 1e-6), its grads (autograd
  through the schedule) against the sequential ones and the reference's
  (rtol 1e-4, atol 1e-5, as the reference test's);
- ``PipelinedTower``: its stage tensors on the stages' devices; its
  forward against ``sequential_reference``, the reference tower and the
  reference's ``sequential_reference`` (rtol 1e-5, atol 1e-5); the
  gradient of the mean loss over its microbatches against the full
  batch's sequential gradient and the reference's (rtol 2e-4, atol 2e-5,
  the reference test's); it trains under ``FusedTrainStep`` (the loss
  falls, as the reference test asks); its flax leaves, a bundle's model
  of its class and a dense checkpoint carry its weights exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paddlebox_tpu.parallel import make_mesh as jax_make_mesh
from paddlebox_tpu.parallel.pipeline import \
    PipelinedTower as FlaxPipelinedTower
from paddlebox_tpu.parallel.pipeline import make_pipeline as jax_make_pipeline
from paddlebox_tpu.parallel.pipeline import \
    sequential_reference as jax_sequential_reference
from paddlebox_tpu_torch.config import BucketSpec, TableConfig, TrainerConfig
from paddlebox_tpu_torch.models.convert import (
    flax_leaves_from_model, model_config, model_from_flax_leaves,
    pipelined_tower_from_flax_leaves)
from paddlebox_tpu_torch.parallel import (PipelinedTower, make_mesh,
                                          make_pipeline,
                                          sequential_reference)
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep
from paddlebox_tpu_torch.trainer.train_step import (
    make_dense_optimizer, sigmoid_binary_cross_entropy)
from paddlebox_tpu_torch.utils.checkpoint import dense_arrays, load_dense

STAGES = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes():
    return (jax_make_mesh(STAGES, axis_names=("pp",)),
            make_mesh(STAGES, device="cpu", axis_names=("pp",)))


def test_make_pipeline_matches_sequential_and_reference(meshes):
    jm, pm = meshes
    rng = np.random.default_rng(0)
    d, m, b = 8, 6, 4
    ws = (rng.normal(size=(STAGES, d, d)) * 0.5).astype(np.float32)
    xs = rng.normal(size=(m, b, d)).astype(np.float32)
    run = make_pipeline(lambda w, x: torch.tanh(x @ w), pm)
    got = run(torch.from_numpy(ws), torch.from_numpy(xs)).numpy()
    want = xs
    for s in range(STAGES):
        want = np.tanh(want @ ws[s])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    ref = jax_make_pipeline(lambda w, x: jnp.tanh(x @ w), jm)
    np.testing.assert_allclose(
        got, np.asarray(ref(jnp.asarray(ws), jnp.asarray(xs))), rtol=1e-5,
        atol=1e-6)


def test_pipeline_grads_match_sequential_and_reference(meshes):
    jm, pm = meshes
    rng = np.random.default_rng(1)
    d, m, b = 4, 3, 2
    ws = (rng.normal(size=(STAGES, d, d)) * 0.5).astype(np.float32)
    xs = rng.normal(size=(m, b, d)).astype(np.float32)
    w = torch.from_numpy(ws).requires_grad_(True)
    make_pipeline(lambda w, x: torch.tanh(x @ w), pm)(
        w, torch.from_numpy(xs)).sum().backward()
    w2 = torch.from_numpy(ws).requires_grad_(True)
    y = torch.from_numpy(xs)
    for s in range(STAGES):
        y = torch.tanh(y @ w2[s])
    y.sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), w2.grad.numpy(), rtol=1e-4,
                               atol=1e-5)
    ref = jax_make_pipeline(lambda w, x: jnp.tanh(x @ w), jm)
    jg = jax.grad(lambda w: ref(w, jnp.asarray(xs)).sum())(jnp.asarray(ws))
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)


def towers(meshes, B=32, S=3, Dp=6, m=4, k=2):
    """The reference tower's init and the port's holding it."""
    jm, pm = meshes
    rng = np.random.default_rng(2)
    sparse = rng.normal(size=(B, S, Dp)).astype(np.float32)
    dense = np.zeros((B, 0), np.float32)
    model = FlaxPipelinedTower(mesh=jm, hidden=16, blocks_per_stage=k,
                               microbatches=m)
    v = model.init(jax.random.PRNGKey(0), jnp.asarray(sparse),
                   jnp.asarray(dense))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(v)]
    port = pipelined_tower_from_flax_leaves(leaves, microbatches=m, mesh=pm)
    return model, v, leaves, port, sparse, dense


def test_tower_places_stages_and_matches_reference(meshes):
    model, v, leaves, port, sparse, dense = towers(meshes)
    assert [tuple(w.shape) for w in port.blocks_w] == [(2, 16, 16)] * STAGES
    assert port.n_stages == STAGES
    x, d = torch.from_numpy(sparse), torch.from_numpy(dense)
    with torch.no_grad():
        got = port(x, d).numpy()
        seq = sequential_reference(port, x, d).numpy()
    np.testing.assert_allclose(got, seq, rtol=1e-5, atol=1e-5)
    want = np.asarray(model.apply(v, jnp.asarray(sparse),
                                  jnp.asarray(dense)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        seq, np.asarray(jax_sequential_reference(
            v, jnp.asarray(sparse), jnp.asarray(dense))),
        rtol=1e-5, atol=1e-5)
    for a, b in zip(flax_leaves_from_model(port), leaves):
        np.testing.assert_array_equal(a, b)


def test_microbatch_grads_equal_full_batch(meshes):
    model, v, leaves, port, sparse, dense = towers(meshes)
    labels = (np.random.default_rng(3).uniform(size=sparse.shape[0]) < 0.5
              ).astype(np.float32)
    x, d, y = (torch.from_numpy(a) for a in (sparse, dense, labels))
    sigmoid_binary_cross_entropy(port(x, d), y).mean().backward()
    got = [t.grad.numpy().copy() if not isinstance(t, tuple) else
           np.stack([q.grad.numpy() for q in t])
           for t, _ in port.flax_slots()]
    port.zero_grad()
    sigmoid_binary_cross_entropy(sequential_reference(port, x, d),
                                 y).mean().backward()
    seq = [np.stack([q.grad.numpy() for q in t]) if isinstance(t, tuple)
           else t.grad.numpy() for t, _ in port.flax_slots()]
    jg = jax.grad(lambda v: optax.sigmoid_binary_cross_entropy(
        model.apply(v, jnp.asarray(sparse), jnp.asarray(dense)),
        jnp.asarray(labels)).mean())(v)
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(jg)]
    for g, s, w in zip(got, seq, want):
        np.testing.assert_allclose(g, s, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5)


def test_trains_under_fused_step(meshes):
    rng = np.random.default_rng(0)
    B, S, vocab = 32, 3, 200
    conf = TableConfig(embedx_dim=4, cvm_offset=3, learning_rate=0.1,
                       embedx_threshold=0.0, initial_range=0.02, seed=1)
    table = DeviceTable(conf, capacity=1024, device="cpu",
                        uniq_buckets=BucketSpec(min_size=256))
    torch.manual_seed(0)
    model = PipelinedTower(S * conf.pull_dim, hidden=16, blocks_per_stage=1,
                           microbatches=4, mesh=meshes[1])
    fs = FusedTrainStep(model, table, TrainerConfig(dense_learning_rate=1e-2),
                        batch_size=B, num_slots=S)
    params, opt = fs.init()
    auc = fs.init_auc_state()
    key_weights = rng.normal(scale=1.5, size=vocab)
    losses = []
    for _ in range(40):
        lengths = rng.integers(1, 3, size=(B, S))
        n = int(lengths.sum())
        keys = np.zeros(512, np.uint64)
        segs = np.full(512, B * S, np.int32)
        k = rng.integers(1, vocab, size=n).astype(np.uint64)
        sg = np.repeat(np.arange(B * S), lengths.reshape(-1)).astype(np.int32)
        keys[:n], segs[:n] = k, sg
        score = np.zeros(B)
        np.add.at(score, sg // S, key_weights[k.astype(np.int64)])
        labels = (rng.uniform(size=B) <
                  1 / (1 + np.exp(-score))).astype(np.float32)
        cvm = np.stack([np.ones(B, np.float32), labels], axis=1)
        params, opt, auc, loss, _ = fs(
            params, opt, auc, keys, segs, cvm, labels,
            np.zeros((B, 0), np.float32), np.ones(B, np.float32))
        losses.append(float(loss))
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) - 0.02, losses


def test_bundle_class_and_checkpoint_carry_the_weights(meshes, tmp_path):
    _, _, leaves, port, sparse, dense = towers(meshes)
    cfg = model_config(port)
    assert cfg == {"class": "PipelinedTower", "kwargs": {
        "hidden": 16, "blocks_per_stage": 2, "microbatches": 4,
        "n_stages": STAGES}}
    back = model_from_flax_leaves(cfg["class"], cfg["kwargs"], leaves,
                                  port.in_dim)
    x, d = torch.from_numpy(sparse), torch.from_numpy(dense)
    with torch.no_grad():
        torch.testing.assert_close(back(x, d), port(x, d), rtol=0, atol=0)
    opt = make_dense_optimizer(TrainerConfig())
    state = opt.init(port)
    arrays = dense_arrays((port, state))
    np.savez(tmp_path / "dense.npz", **arrays)
    fresh = PipelinedTower(port.in_dim, hidden=16, blocks_per_stage=2,
                           microbatches=4, mesh=meshes[1])
    load_dense(str(tmp_path / "dense.npz"), (fresh, opt.init(fresh)))
    for a, b in zip(flax_leaves_from_model(fresh), leaves):
        np.testing.assert_array_equal(a, b)
