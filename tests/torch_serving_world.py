"""Shared fixtures of the port's serving tests (no test collected here):
a small DeepFM bundle written by the JAX package over the fake feed of
``torch_serving_fakes`` (a label and two sparse slots, B=8), its table,
and checkpoint trails written by either package's ``PassManager``."""

import os

import jax
import numpy as np

from paddlebox_tpu.config import DataFeedConfig as JaxFeedConfig
from paddlebox_tpu.config import SlotConfig as JaxSlotConfig
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.data.dataset import SlotDataset as JaxDataset
from paddlebox_tpu.inference.predictor import \
    save_inference_model as jax_save
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.ps.server import SparsePS as JaxSparsePS
from paddlebox_tpu.ps.table import EmbeddingTable as JaxTable
from paddlebox_tpu.trainer.pass_manager import PassManager as JaxPassManager
from paddlebox_tpu_torch.config import TableConfig
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.models.convert import deepfm_from_flax_leaves
from paddlebox_tpu_torch.ps.server import SparsePS
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.trainer.pass_manager import PassManager
from torch_serving_fakes import feed_conf

B = 8
HIDDEN = (8,)
TABLE = dict(embedx_dim=4, cvm_offset=3, embedx_threshold=5.0, seed=7)
KEYS = np.arange(1, 81, dtype=np.uint64)     # the lines draw from [1, 99)
DAY = "20260803"


def jax_feed() -> JaxFeedConfig:
    return JaxFeedConfig(
        slots=[JaxSlotConfig("label", type="float", is_dense=True, dim=1),
               JaxSlotConfig("slot_a"), JaxSlotConfig("slot_b")],
        batch_size=B)


def rows(rng, n: int, dim: int) -> np.ndarray:
    """Table rows: show in [0, 10) (some under the embedx threshold),
    clk under it, the rest small normals."""
    values = (rng.normal(size=(n, dim)) * 0.1).astype(np.float32)
    show = rng.integers(0, 10, size=n)
    values[:, 0] = show
    values[:, 1] = np.floor(show * rng.uniform(0, 0.3, size=n))
    return values


def flax_params(seed: int, hidden=HIDDEN):
    conf = JaxTableConfig(**TABLE)
    model = FlaxDeepFM(hidden=hidden)
    params = model.init(jax.random.PRNGKey(seed),
                        np.zeros((B, 2, conf.pull_dim), np.float32),
                        np.zeros((B, 0), np.float32))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [(rng.normal(size=np.shape(x)) * 0.3).astype(np.float32)
              for x in leaves]
    return model, jax.tree_util.tree_unflatten(treedef, leaves), leaves


def jax_bundle(root: str, name: str = "bundle", seed: int = 0,
               hidden=HIDDEN, version: str = "19700101/00000"):
    """A bundle the JAX package exports: (path, its table, flax leaves)."""
    conf = JaxTableConfig(**TABLE)
    table = JaxTable(conf)
    rng = np.random.default_rng(100 + seed)
    table.import_rows(KEYS, rows(rng, KEYS.size, conf.pull_dim),
                      np.zeros((KEYS.size, 2), np.float32))
    model, params, leaves = flax_params(seed, hidden)
    path = jax_save(os.path.join(root, name), model, params, table,
                    jax_feed(), conf, version=version)
    return path, table, leaves


def jax_trail(root: str, table, params_leaves, passes, seed: int = 1):
    """Commit a trail with the JAX ``PassManager``: a base at the first
    pass (the table and ``params_leaves`` as its dense state), then for
    each later pass a delta after rewriting some rows and adding new
    keys. Returns the table."""
    _, params, _ = flax_params(0)
    treedef = jax.tree_util.tree_structure(params)
    dense = jax.tree_util.tree_unflatten(treedef, params_leaves)
    ps = JaxSparsePS({"embedding": table})
    pm = JaxPassManager(ps, root, [JaxDataset(jax_feed())])
    pm.set_date(DAY)
    rng = np.random.default_rng(seed)
    for i, pass_id in enumerate(passes):
        pm.pass_id = pass_id
        if i == 0:
            pm.save_base(dense_state=dense, wait=True)
            continue
        change(table, rng, pass_id)
        pm.save_delta(wait=True)
    pm.close()
    return table


def change(table, rng, pass_id: int) -> None:
    """Rewrite 10 known rows and add 5 new keys (some gated)."""
    known = rng.choice(KEYS, size=10, replace=False)
    fresh = np.arange(100 + 10 * pass_id, 105 + 10 * pass_id,
                      dtype=np.uint64)
    keys = np.concatenate([known, fresh])
    table.import_rows(keys, rows(rng, keys.size, table.conf.pull_dim),
                      np.zeros((keys.size, 2), np.float32))


def port_trail(root: str, passes, seed: int = 1, dense_seed: int = 3):
    """The same kind of trail from the port's ``PassManager`` over a host
    ``EmbeddingTable`` of the bundle's keys, its base holding the dense
    leaves of a DeepFM from ``dense_seed``."""
    conf = TableConfig(**TABLE)
    table = EmbeddingTable(conf, backend="numpy")
    rng = np.random.default_rng(200)
    table.import_rows(KEYS, rows(rng, KEYS.size, conf.pull_dim),
                      np.zeros((KEYS.size, 2), np.float32))
    model = deepfm_from_flax_leaves(flax_params(dense_seed)[2], HIDDEN)
    pm = PassManager(SparsePS({"embedding": table}), root,
                     [SlotDataset(feed_conf())])
    pm.set_date(DAY)
    rng = np.random.default_rng(seed)
    for i, pass_id in enumerate(passes):
        pm.pass_id = pass_id
        if i == 0:
            pm.save_base(dense_state=(model, {}), wait=True)
            continue
        change(table, rng, pass_id)
        pm.save_delta(wait=True)
    pm.close()
    return table
