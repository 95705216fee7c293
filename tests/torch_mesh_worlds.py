"""Worlds of the mesh parity tests: the reference's ``FusedShardedTrainStep``
over its ``ShardedDeviceTable`` on the JAX package's CPU mesh, and the
port's on ``make_mesh(ndev, device="cpu")``, from the same flax params
(converted), the same table config and the same arenas (carried); the
reference tests' batch maker
(``tests/test_mesh_device_prep.py::make_batch``)."""

import jax
import numpy as np
import torch

from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.config import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.models import WideDeep as FlaxWideDeep
from paddlebox_tpu.parallel import make_mesh as jax_make_mesh
from paddlebox_tpu.parallel.fused_dp_step import \
    FusedShardedTrainStep as JaxShardedStep
from paddlebox_tpu.ps.sharded_device_table import \
    ShardedDeviceTable as JaxShardedTable
from paddlebox_tpu_torch.config import TableConfig, TrainerConfig
from paddlebox_tpu_torch.models.convert import widedeep_from_flax_leaves
from paddlebox_tpu_torch.parallel.fused_dp_step import FusedShardedTrainStep
from paddlebox_tpu_torch.parallel.mesh import make_mesh
from paddlebox_tpu_torch.ps.sharded_device_table import (ShardedDeviceTable,
                                                         shard_of)

HIDDEN = (16,)
TABLE = dict(embedx_dim=4, cvm_offset=3, embedx_threshold=0.0,
             initial_range=0.0, learning_rate=0.1, seed=3)


def make_batch(rng, ndev, B, S, npad, vocab, skew_owner=None):
    """[ndev, ...] batch arrays; ``skew_owner`` routes every key to one
    shard."""
    keys = np.zeros((ndev, npad), np.uint64)
    segs = np.full((ndev, npad), B * S, np.int32)
    for d in range(ndev):
        n = int(rng.integers(npad // 2, npad - 8))
        k = rng.integers(1, vocab, size=4 * n).astype(np.uint64)
        if skew_owner is not None:
            k = k[shard_of(k, ndev) == skew_owner][:n]
            n = k.size
        else:
            k = k[:n]
        keys[d, :n] = k
        segs[d, :n] = np.sort(rng.integers(0, B * S, size=n)
                              ).astype(np.int32)
    labels = (rng.uniform(size=(ndev, B)) < 0.5).astype(np.float32)
    cvm = np.stack([np.ones_like(labels), labels], axis=-1)
    return (keys, segs, cvm, labels, np.zeros((ndev, B, 0), np.float32),
            np.ones((ndev, B), np.float32))


def worlds(ndev, device_prep, B, S, cap=4096, backend="native",
           table_kw=None, dense_lr=1e-2, **step_kw):
    """(reference (step, table, [params, opt, auc]), port (step, table,
    [params, opt, auc])): the same flax params and table config."""
    kw = dict(TABLE, **(table_kw or {}))
    jt = JaxShardedTable(JaxTableConfig(**kw), jax_make_mesh(ndev),
                         capacity_per_shard=cap, backend=backend)
    js = JaxShardedStep(FlaxWideDeep(hidden=HIDDEN), jt,
                        JaxTrainerConfig(dense_learning_rate=dense_lr),
                        batch_size=B, num_slots=S, device_prep=device_prep,
                        **step_kw)
    jp, jo = js.init(jax.random.PRNGKey(0))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    pt = ShardedDeviceTable(TableConfig(**kw), make_mesh(ndev, device="cpu"),
                            capacity_per_shard=cap, backend=backend)
    carry_arenas(jt, pt)
    ps = FusedShardedTrainStep(widedeep_from_flax_leaves(leaves, HIDDEN), pt,
                               TrainerConfig(dense_learning_rate=dense_lr),
                               batch_size=B, num_slots=S,
                               device_prep=device_prep, **step_kw)
    return ((js, jt, [jp, jo, js.init_auc_state()]),
            (ps, pt, [*ps.init(), ps.init_auc_state()]))


def carry_arenas(jt, pt):
    """The reference table's arenas into the port's shards (the two draw
    their random init from different generators)."""
    vals, state = np.array(jt.values), np.array(jt.state)
    for s in range(pt.ndev):
        pt.values[s].copy_(torch.from_numpy(vals[s]))
        pt.state[s].copy_(torch.from_numpy(state[s]))


def step_both(ref, port, args, device_prep):
    """One step of each world over ``args``; returns (ref loss, port
    loss)."""
    js, jt, jst = ref
    ps, pt, pst = port
    if device_prep:
        *jst[:], jl, _ = js.step_device(*jst, *args)
        *pst[:], pl, _ = ps.step_device(*pst, *args)
    else:
        *jst[:], jl, _ = js(*jst, jt.prepare_batch(args[0]), *args[1:])
        *pst[:], pl, _ = ps(*pst, pt.prepare_batch(args[0]), *args[1:])
    return float(jl), float(pl)


def rows_by_key(snap):
    order = np.argsort(snap["keys"])
    return snap["keys"][order], snap["values"][order], snap["state"][order]


def assert_tables_match(jt, pt, atol=1e-5):
    """Every row by key: keys exact, show/clk exact, the rest within
    ``atol``; the shards' fill equal."""
    assert list(jt._sizes) == list(pt._sizes)
    jk, jv, js = rows_by_key(jt.snapshot())
    pk, pv, pst = rows_by_key(pt.snapshot())
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pv[:, :2], jv[:, :2])
    np.testing.assert_allclose(pv, jv, rtol=0, atol=atol)
    np.testing.assert_allclose(pst, js, rtol=0, atol=atol)
