"""Worlds of the multi-host parity tests: two ranks as threads, each with a
``Coordinator``, a ``DistributedTable`` over a host ``EmbeddingTable`` (its
half of the keys), a ``TieredShardedDeviceTable`` (writeback "delta") on a
4-shard mesh and a ``FusedShardedTrainStep`` with ``sparse_grad_scale =
1 / world``, the dense params averaged over the ranks after every step.
The reference's side is its own test's (``tests/test_multihost_multichip.py``
``train_rank``, ``sync_params_mean``, ``rank_batches``); the port's side
is the same loop over the port's classes, from the reference's flax
params (converted)."""

import jax
import jax.numpy as jnp
import numpy as np

from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.parallel import make_mesh as jax_make_mesh
from paddlebox_tpu.parallel.coordinator import Coordinator as JaxCoordinator
from paddlebox_tpu.parallel.coordinator import \
    local_endpoints as jax_local_endpoints
from paddlebox_tpu_torch.config import TableConfig, TrainerConfig
from paddlebox_tpu_torch.models.convert import (deepfm_from_flax_leaves,
                                                flax_leaves_from_model)
from paddlebox_tpu_torch.parallel.coordinator import (Coordinator,
                                                      dense_mean_hook,
                                                      local_endpoints)
from paddlebox_tpu_torch.parallel.fused_dp_step import FusedShardedTrainStep
from paddlebox_tpu_torch.parallel.mesh import make_mesh
from paddlebox_tpu_torch.ps.distributed import DistributedTable
from paddlebox_tpu_torch.ps.tiered_table import TieredShardedDeviceTable
from test_multihost_multichip import (BL, NDEV, PASSES, S, STEPS_PER_PASS,
                                      WORLD, rank_batches, run_rank_threads,
                                      sync_params_mean, train_rank)

HIDDEN = (16,)
# the reference test's table fixture
TABLE = dict(embedx_dim=4, cvm_offset=3, optimizer="adagrad",
             learning_rate=0.1, embedx_threshold=0.0, initial_range=0.01,
             show_clk_decay=1.0, seed=3)
SGD = dict(dense_optimizer="sgd", dense_learning_rate=0.05)


def data(vocab: int, seed: int):
    """Each rank's batches (keys of rank r: key % WORLD == r), as the
    reference test draws them."""
    rng = np.random.default_rng(seed)
    kw = rng.normal(scale=1.2, size=vocab)
    return [rank_batches(r, vocab, kw) for r in range(WORLD)]


def flax_leaves():
    """The reference ranks' initial dense params (``fs.init(PRNGKey(0))``
    of ``DeepFM(hidden=(16,))`` at batch BL), as numpy leaves."""
    D = JaxTableConfig(**TABLE).pull_dim
    params = FlaxDeepFM(hidden=HIDDEN).init(
        jax.random.PRNGKey(0), jnp.zeros((BL, S, D)), jnp.zeros((BL, 0)))
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def local_rows(local):
    """A rank's shard of the PS, by key: (keys, values, state)."""
    n = local._size
    keys = local._index.dump_keys(n)
    live = keys != 0
    order = np.argsort(keys[live])
    return (keys[live][order], local._values[:n][live][order],
            local._state[:n][live][order])


def ref_ranks(batches, device_prep=False, insert_mode="ensure"):
    """The reference's two ranks (``train_rank``): per rank (rows of its
    shard by key, dense leaves, losses)."""
    devs = jax.devices()
    eps = jax_local_endpoints(WORLD)
    coords = [JaxCoordinator(r, eps) for r in range(WORLD)]
    meshes = [jax_make_mesh(devices=devs[r * NDEV:(r + 1) * NDEV])
              for r in range(WORLD)]
    conf = JaxTableConfig(**TABLE)
    out = run_rank_threads(
        lambda r: train_rank(r, coords[r], meshes[r], conf, batches[r],
                             sync_params_mean, device_prep=device_prep,
                             insert_mode=insert_mode),
        coords)
    res = []
    for keys, vals, st, params, losses in out:
        live = keys != 0
        order = np.argsort(keys[live])
        res.append(((keys[live][order], vals[live][order],
                     st[live][order]),
                    [np.asarray(x) for x in
                     jax.tree_util.tree_leaves(params)], losses))
    return res


def port_rank(coord, conf, leaves, batches, device_prep=False,
              insert_mode="ensure", lr_scale=1.0):
    """The reference's ``train_rank`` over the port's classes: one rank's
    ``PASSES`` passes of ``STEPS_PER_PASS`` steps on an ``NDEV``-shard CPU
    mesh, the dense mean after every step, the dense lr ``lr_scale``
    times the test's. Returns (rows of its shard by key, dense leaves,
    losses)."""
    tconf = TrainerConfig(**dict(
        SGD, dense_learning_rate=SGD["dense_learning_rate"] * lr_scale))
    backing = DistributedTable(conf, coord)
    table = TieredShardedDeviceTable(
        conf, make_mesh(NDEV, device="cpu"), backing=backing,
        capacity_per_shard=1 << 12, writeback_mode="delta")
    fs = FusedShardedTrainStep(deepfm_from_flax_leaves(leaves, HIDDEN),
                               table, tconf, batch_size=BL, num_slots=S,
                               dense_dim=0, sparse_grad_scale=1.0 / WORLD,
                               device_prep=device_prep,
                               insert_mode=insert_mode)
    hook = dense_mean_hook(coord)
    params, opt = fs.init()
    auc = fs.init_auc_state()
    per = STEPS_PER_PASS
    losses = []
    for p in range(PASSES):
        chunk = batches[p * per:(p + 1) * per]
        table.begin_feed_pass(np.concatenate([b[0].ravel() for b in chunk]))
        for keys, segs, labels in chunk:
            lead = keys.shape[0]
            cvm = np.stack([np.ones((lead, BL), np.float32), labels], axis=2)
            dense = np.zeros((lead, BL, 0), np.float32)
            mask = np.ones((lead, BL), np.float32)
            if device_prep:
                out = fs.step_device(params, opt, auc, keys, segs, cvm,
                                     labels, dense, mask)
            else:
                out = fs(params, opt, auc, table.prepare_batch(keys), segs,
                         cvm, labels, dense, mask)
            params, opt, auc = out[0], out[1], out[2]
            losses.append(float(out[3]))
            params = hook(params)
        if device_prep:
            drained, _ = table.poll_misses()
            assert drained == 0, "a staged pass reported ring misses"
        table.end_pass()
    return (local_rows(backing.local), flax_leaves_from_model(params),
            losses)


def port_ranks(batches, device_prep=False, insert_mode="ensure",
               lr_scale=1.0):
    """The port's two ranks (threads), each as ``port_rank``."""
    conf = TableConfig(**TABLE)
    leaves = flax_leaves()
    eps = local_endpoints(WORLD)
    coords = [Coordinator(r, eps) for r in range(WORLD)]
    return run_rank_threads(
        lambda r: port_rank(coords[r], conf, leaves, batches[r],
                            device_prep, insert_mode, lr_scale), coords)


def assert_rows_close(got, want, atol=1e-5):
    """Rows by key: the same keys, show/clk exact, the rest within
    ``atol``."""
    gk, gv, gs = got
    wk, wv, ws = want
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv[:, :2], wv[:, :2])
    np.testing.assert_allclose(gv, wv, rtol=0, atol=atol)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=atol)
