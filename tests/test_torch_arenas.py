"""The port's low-precision and variable arenas (``DeviceTable`` with
``value_dtype`` bfloat16 or int8, ``TableConfig(variable_embedding=True)``
alone and with int8), bf16 dense compute and the numeric-sentinel hook,
held against the JAX package on the same numpy-seeded inputs. Arenas are
carried across with ``load_arena`` (never two random inits); on the CPU
the push is its plain version, ``sparse_push_plain``.

Tolerances:

- show/clk and the variable layout's size codes exact;
- int8 codes within 1 of the reference's, scales within rtol 1e-6: XLA
  divides by 127 as a multiply by its reciprocal (a scale may differ in
  its last bit), the port divides, so a code at a rounding tie may flip.
  A group whose new maximum comes out of a cancellation (w - lr * step)
  carries the values' absolute tolerance into its scale, so scales also
  get that atol over 127;
- a dequantized value within one quantum (its group's scale) of the
  reference's; bfloat16 values within one bfloat16 spacing;
- other float32 values and the optimizer state within 1e-6 (sums in
  another order); after trainer steps 1e-5, losses rtol 1e-5;
- bf16 dense compute (a model of ``dtype`` bfloat16): logits and losses
  within rtol 2^-6 and atol 2^-8 of flax's (products rounded to
  bfloat16's 8 significant bits in another order; measured: a few
  bfloat16 spacings at most). ``TrainerConfig(bf16=True)`` over a float32
  model only rounds the model's inputs: 1e-5 as in float32.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_slot_file
from paddlebox_tpu.config import BucketSpec as JaxBucketSpec
from paddlebox_tpu.config import DataFeedConfig as JaxFeedConfig
from paddlebox_tpu.config import SlotConfig as JaxSlotConfig
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.config import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.data.dataset import SlotDataset as JaxSlotDataset
from paddlebox_tpu.inference.predictor import CTRPredictor as JaxPredictor
from paddlebox_tpu.inference.predictor import \
    save_inference_model as jax_save
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.models import FeedDNN as FlaxFeedDNN
from paddlebox_tpu.models import MMoE as FlaxMMoE
from paddlebox_tpu.models import WideDeep as FlaxWideDeep
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu.ps.device_table import DeviceTable as JaxDeviceTable
from paddlebox_tpu.ps.table import EmbeddingTable as JaxTable
from paddlebox_tpu.trainer import trainer as ref_trainer
from paddlebox_tpu.trainer.fused_step import FusedTrainStep as JaxStep
from paddlebox_tpu_torch.config import (BucketSpec, DataFeedConfig,
                                        TableConfig, TrainerConfig)
from paddlebox_tpu_torch.data import criteo
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.inference.predictor import (CTRPredictor,
                                                     save_inference_model)
from paddlebox_tpu_torch.models.convert import (build_model,
                                                deepfm_from_flax_leaves,
                                                flax_leaves_from_model,
                                                load_flax_leaves)
from paddlebox_tpu_torch.ops import sparse_push
from paddlebox_tpu_torch.ps.device_table import ArenaLayout, DeviceTable
from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep
from paddlebox_tpu_torch.trainer.trainer import CTRTrainer

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}
VAR = dict(embedx_dim=4, expand_dim=6, variable_embedding=True)
B, S, DD, NPAD = 16, 3, 2, 256
HIDDEN = (16, 8)
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 2.0 ** -8


@pytest.fixture(autouse=True)
def one_torch_thread():
    """JAX's CPU thread pools spin beside torch's intra-op threads and slow
    these small torch ops several times over; one thread is enough."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(dtype="int8", backend="numpy", capacity=256, **kw):
    """The reference's table and the port's, holding the same arena."""
    jd, pd = DTYPES[dtype]
    base = dict(embedx_dim=4, cvm_offset=3, embedx_threshold=2.0,
                initial_range=0.05, seed=3)
    base.update(kw)
    jt = JaxDeviceTable(JaxTableConfig(**base), capacity=capacity,
                        uniq_buckets=JaxBucketSpec(min_size=64),
                        backend=backend, index_threads=1, value_dtype=jd)
    pt = DeviceTable(TableConfig(**base), capacity=capacity,
                     uniq_buckets=BucketSpec(min_size=64), device="cpu",
                     backend=backend, index_threads=1, value_dtype=pd)
    carry(jt, pt)
    return jt, pt


def carry(jt, pt):
    pt.load_arena(np.asarray(jt.values, np.float32), np.asarray(jt.state),
                  jt._index.dump_keys(jt._size))


def assert_arenas_close(pt, jt, atol=1e-6, scale_rtol=1e-6):
    """Every used row of the two arenas under the tolerances above."""
    n = jt._size
    lay = pt.layout
    pv = pt.values[:n].float().numpy()
    jv = np.asarray(jt.values, np.float32)[:n]
    ps, js = pt.state[:n].numpy(), np.asarray(jt.state)[:n]
    so = lay.stat_off
    stats = (ps, js) if lay.stats_in_state else (pv, jv)
    np.testing.assert_array_equal(stats[0][:, :2], stats[1][:, :2])
    if lay.variable:
        np.testing.assert_array_equal(ps[:, lay.size_col],
                                      js[:, lay.size_col])
    ocols = slice(so, so + int(lay.state_offsets[-1]))
    np.testing.assert_allclose(ps[:, ocols], js[:, ocols], rtol=0,
                               atol=atol)
    if lay.quantized:
        assert np.abs(pv - jv).max() <= 1
        np.testing.assert_allclose(ps[:, 2:so], js[:, 2:so],
                                   rtol=scale_rtol, atol=atol / 127.0)
        for gi, (start, width, _) in enumerate(lay.groups):
            a = pv[:, start:start + width] * ps[:, 2 + gi:3 + gi]
            b = jv[:, start:start + width] * js[:, 2 + gi:3 + gi]
            quantum = np.maximum(ps[:, 2 + gi:3 + gi], js[:, 2 + gi:3 + gi])
            assert np.all(np.abs(a - b) <= quantum * 1.001 + atol)
    elif lay.value_dtype == torch.bfloat16:
        spacing = 2.0 ** -7 * np.maximum(np.abs(pv), np.abs(jv))
        assert np.all(np.abs(pv - jv) <= spacing + atol)
    else:
        np.testing.assert_allclose(pv, jv, rtol=0, atol=atol)


def grads(rng, layout, n, dest=None):
    """Grads of ``n`` keys at the pull width: show 1, clk 0/1; under the
    variable layout each key sends to the base group, the expand group or
    both (``dest`` 0, 1, 2; random by default)."""
    g = (rng.normal(size=(n, layout.grad_dim)) * 0.3).astype(np.float32)
    g[:, 0] = 1.0
    g[:, 1] = rng.integers(0, 2, size=n)
    if layout.variable:
        s, ex, ed = layout.groups[-1][0], layout.conf.embedx_dim, \
            layout.conf.expand_dim
        if dest is None:
            dest = rng.choice(3, size=n, p=[0.45, 0.45, 0.1])
        g[dest == 0, s + ex:s + ex + ed] = 0.0
        g[dest == 1, s:s + ex] = 0.0
    return g


def push_both(jt, pt, idx, g):
    jt.values, jt.state = jt.device_push(
        jt.values, jt.state, jnp.asarray(g), jnp.asarray(idx.inverse),
        jnp.asarray(idx.uniq_rows), jnp.asarray(idx.uniq_mask))
    pt.device_push(pt.values, pt.state, torch.from_numpy(g),
                   torch.from_numpy(idx.inverse),
                   torch.from_numpy(idx.uniq_rows),
                   torch.from_numpy(idx.uniq_mask))


def pulls(jt, pt, keys):
    ji = jt.prepare_batch(keys, create=False)
    pi = pt.prepare_batch(keys, create=False)
    np.testing.assert_array_equal(pi.rows, ji.rows)
    return (pt.device_pull(pt.values, torch.from_numpy(pi.rows),
                           pt.state).numpy(),
            np.asarray(jt.device_pull(jt.values, ji.rows, jt.state)))


def assert_pulls_close(got, want, layout, jt, rows):
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    if layout.quantized:
        st = np.asarray(jt.state)[rows]
        quantum = st[:, 2:layout.stat_off].max(axis=1, keepdims=True)
        assert np.all(np.abs(got - want) <= quantum * 1.001 + 1e-6)
    elif layout.value_dtype == torch.bfloat16:
        assert np.all(np.abs(got - want) <=
                      2.0 ** -7 * np.abs(want) + 1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- the layout ----------------------------------------------------------------

@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
@pytest.mark.parametrize("variable", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_layout_matches_reference(dtype, variable, opt):
    """Columns, groups, state offsets, stat prefix, size column and bytes
    as the reference's; the push descriptor names the variant."""
    kw = dict(VAR) if variable else {}
    jt, pt = pair(dtype, capacity=32, optimizer=opt, **kw)
    jl, pl = jt.layout, pt.layout
    assert (pl.dim, pl.state_dim, pl.stat_off, pl.groups) == \
        (jl.dim, jl.state_dim, jl.stat_off, jl.groups)
    assert list(pl.state_offsets) == list(jl.state_offsets)
    assert (pl.stats_in_state, pl.quantized, pl.variable) == \
        (jl.stats_in_state, jl.quantized, jl.variable)
    if variable:
        assert (pl.size_col, pl.var_width) == (jl.size_col, jl.var_width)
    assert pt.memory_bytes() == jt.memory_bytes()
    assert pt.values.dtype == DTYPES[dtype][1]
    assert sparse_push.push_variant(pl) == \
        ("var_" if variable else "") + dtype
    assert list(pl.push_desc)[:3] == [("f32", "bf16", "int8").index(dtype),
                                      int(variable), len(pl.groups)]


def test_other_dtypes_raise():
    for bad in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(ValueError, match="value_dtype"):
            ArenaLayout(TableConfig(), bad)


def test_int8_init_quantizes_at_the_shared_scale():
    """Fresh int8 rows: codes in [-127, 127] at scale max(r, 1e-6) / 127
    in every group's scale column, show/clk and row 0 zero."""
    conf = TableConfig(embedx_dim=4, initial_range=0.02)
    t = DeviceTable(conf, capacity=64, device="cpu", value_dtype=torch.int8)
    so = t.layout.stat_off
    np.testing.assert_array_equal(t.state[:, 2:so].numpy(),
                                  np.float32(0.02 / 127.0))
    q = t.values.numpy().copy()
    assert q.dtype == np.int8 and np.abs(q).max() == 127
    assert not q[:, :2].any() and not q[0].any()
    assert not t.state[:, :2].any()
    t._rerandomize()
    assert not np.array_equal(t.values.numpy(), q)


# -- pull and push -----------------------------------------------------------

@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_pull_push_match_reference(dtype, opt):
    """Three pushes of keys with repeats, unknown and padding keys (rows
    crossing the embedx threshold on the way): arenas and pulls."""
    jt, pt = pair(dtype, optimizer=opt)
    rng = np.random.default_rng(1)
    keys = rng.integers(1, 60, size=90).astype(np.uint64)
    keys[-10:] = 0
    keys[:5] = 1000 + np.arange(5)
    jt.prepare_batch(keys[5:])
    pt.prepare_batch(keys[5:])
    for _ in range(3):
        idx = jt.prepare_batch(keys, create=False)
        push_both(jt, pt, idx, grads(rng, pt.layout, keys.size))
        assert_arenas_close(pt, jt)
    got, want = pulls(jt, pt, keys)
    assert_pulls_close(got, want, pt.layout, jt,
                       jt.prepare_batch(keys, create=False).rows)


def test_gated_group_survives_hot_neighbor():
    """Per-group scales (``tests/test_device_table.py``'s case): a still
    gated embedx group's codes stay within one re-round of their own
    scale while the embed_w group grows, in both packages alike."""
    jt, pt = pair("int8", capacity=64, optimizer="sgd", learning_rate=0.5,
                  embedx_threshold=1e9, initial_range=0.02)
    keys = np.array([5, 6], np.uint64)
    idx = jt.prepare_batch(keys)
    pt.prepare_batch(keys)
    rows = torch.from_numpy(idx.rows.astype(np.int64))
    before = pt.values[rows, 3:7].float() * pt.state[rows, 3:4]
    g = np.zeros((2, pt.layout.grad_dim), np.float32)
    g[:, 0] = 1.0
    g[:, 2] = -4.0
    for _ in range(20):
        push_both(jt, pt, idx, g)
    assert_arenas_close(pt, jt)
    w = pt.values[rows, 2].float() * pt.state[rows, 2]
    assert bool((w.abs() > 1.0).all())
    after = pt.values[rows, 3:7].float() * pt.state[rows, 3:4]
    np.testing.assert_allclose(after.numpy(), before.numpy(),
                               atol=0.02 / 127.0 + 1e-7)
    assert float(after.abs().max()) > 0.001


# -- the variable layout -----------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_variable_routing_and_claim_match_reference(dtype):
    """Unclaimed rows pull zeros in both groups; a push claims each row for
    the first group with a nonzero merged grad (base on a tie); the union
    storage then pulls into its group and zeros the other; three more
    pushes of mixed destinations train each row's own group only."""
    jt, pt = pair(dtype, embedx_threshold=0.0, initial_range=0.02, **VAR)
    lay = pt.layout
    assert (pt.dim, lay.grad_dim) == (9, 13)
    keys = np.arange(1, 31, dtype=np.uint64)
    idx = jt.prepare_batch(keys)
    pt.prepare_batch(keys)
    got, want = pulls(jt, pt, keys)
    assert not got[:, 3:].any() and not want[:, 3:].any()
    rng = np.random.default_rng(2)
    dest = np.arange(30) % 3
    push_both(jt, pt, idx, grads(rng, lay, 30, dest))
    codes = pt.state[torch.from_numpy(idx.rows.astype(np.int64)),
                     lay.size_col].numpy()
    np.testing.assert_array_equal(codes, np.where(dest == 1, 2.0, 1.0))
    for _ in range(3):
        push_both(jt, pt, idx, grads(rng, lay, 30))
        assert_arenas_close(pt, jt)
    got, want = pulls(jt, pt, keys)
    assert_pulls_close(got, want, lay, jt, idx.rows)
    base, expand = got[:, 3:7], got[:, 7:13]
    assert not base[dest == 1].any() and not expand[dest != 1].any()
    assert np.abs(base[dest != 1]).min(axis=1).all()


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_variable_cross_group_grads_dropped_after_claim(dtype):
    """A row claimed base stays base: expand grads at it change nothing
    but show/clk (and, int8, a requantization at the same scale)."""
    jt, pt = pair(dtype, embedx_threshold=0.0, initial_range=0.0,
                  learning_rate=0.1, **VAR)
    keys = np.array([7], np.uint64)
    idx = jt.prepare_batch(keys)
    pt.prepare_batch(keys)
    g = np.zeros((1, 13), np.float32)
    g[:, 0] = 1.0
    g[:, 3:7] = 0.5
    push_both(jt, pt, idx, g)
    before = pulls(jt, pt, keys)[0]
    g2 = np.zeros((1, 13), np.float32)
    g2[:, 7:13] = 9.0
    push_both(jt, pt, idx, g2)
    after, want = pulls(jt, pt, keys)
    np.testing.assert_allclose(after[:, 2:], before[:, 2:], atol=1e-7)
    np.testing.assert_allclose(after, want, atol=1e-6)
    assert float(pt.state[int(idx.rows[0]), pt.layout.size_col]) == 1.0
    assert_arenas_close(pt, jt)


# -- canonical snapshots -----------------------------------------------------

SNAPSHOT_CASES = [
    # (saver package, saver dtype, loader package, loader dtype, variable)
    ("port", "int8", "ref", "f32", False),
    ("ref", "int8", "port", "f32", False),
    ("port", "f32", "ref", "int8", False),
    ("ref", "bf16", "port", "int8", False),
    ("port", "bf16", "port", "f32", False),
    ("port", "int8", "ref", "int8", True),
    ("ref", "f32", "port", "int8", True),
]


@pytest.mark.parametrize("src,sdt,dst,ddt,variable", SNAPSHOT_CASES)
def test_snapshots_cross_precisions_and_packages(tmp_path, src, sdt, dst,
                                                 ddt, variable):
    """A trained table saved by one package at one value dtype loads into
    the other (or the same) package at another: the pulls agree within
    the loader's precision (int8: a quantum of the row's groups; bf16: a
    spacing), show/clk and size codes exactly; ``snapshot_delta`` and
    ``load_delta`` take the same layout."""
    conf = dict(embedx_dim=4, cvm_offset=3, embedx_threshold=0.0,
                initial_range=0.05, seed=3)
    conf.update(VAR if variable else {})
    jt, pt = pair(sdt, **conf)
    rng = np.random.default_rng(4)
    keys = np.arange(1, 41, dtype=np.uint64)
    idx = jt.prepare_batch(keys)
    pt.prepare_batch(keys)
    for _ in range(2):
        push_both(jt, pt, idx, grads(rng, pt.layout, keys.size))
    saver = pt if src == "port" else jt
    path = str(tmp_path / "t.npz")
    saver.save(path)
    with np.load(path) as snap:
        assert snap["values"].dtype == np.float32
        assert snap["values"].shape == (40, pt.dim)
    jd, pd = DTYPES[ddt]
    if dst == "port":
        loader = DeviceTable(TableConfig(**conf), capacity=64, device="cpu",
                             backend="numpy", value_dtype=pd)
    else:
        loader = JaxDeviceTable(JaxTableConfig(**conf), capacity=64,
                                backend="numpy", value_dtype=jd)
    loader.load(path)
    li = loader.prepare_batch(keys, create=False)
    ji = jt.prepare_batch(keys, create=False)
    if dst == "port":
        got = loader.device_pull(loader.values, torch.from_numpy(li.rows),
                                 loader.state).numpy()
    else:
        got = np.asarray(loader.device_pull(loader.values, li.rows,
                                            loader.state))
    if src == "port":
        want = pt.device_pull(pt.values, torch.from_numpy(ji.rows),
                              pt.state).numpy()
    else:
        want = np.asarray(jt.device_pull(jt.values, ji.rows, jt.state))
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    tol = 1e-6 + np.abs(want).max(axis=1, keepdims=True) * (
        1 / 127.0 if ddt == "int8" else 2.0 ** -7 if ddt == "bf16" else 0)
    assert np.all(np.abs(got - want) <= tol)
    if dst == "port":
        # the delta of a load names every loaded row, in the same layout
        loader.load_delta(path)
        delta = loader.snapshot_delta()
        assert sorted(delta["keys"]) == sorted(keys)
        assert delta["values"].shape == (40, pt.dim)


# -- the fused step ----------------------------------------------------------

def make_batches(seed, n, vocab=120):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(1, 4, size=B * S)
        k = int(lengths.sum())
        keys = np.zeros(NPAD, np.uint64)
        keys[:k] = rng.integers(1, vocab, size=k)
        segs = np.full(NPAD, B * S, np.int32)
        segs[:k] = np.repeat(np.arange(B * S, dtype=np.int32), lengths)
        labels = (rng.uniform(size=B) < 0.4).astype(np.float32)
        cvm = np.stack([np.ones(B, np.float32), labels], axis=1)
        dense = rng.normal(size=(B, DD)).astype(np.float32)
        row_mask = np.ones(B, np.float32)
        row_mask[-2:] = 0.0
        out.append((keys, segs, cvm, labels, dense, row_mask))
    return out


def leaves_of(params):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def step_worlds(dtype, device_prep, bf16=False, model_dtype=None, **kw):
    """The reference's ``FusedTrainStep`` and the port's over tables of
    ``dtype`` holding the same arena (host prep: numpy index; device prep:
    the native single map, prepopulated), from the same weights."""
    backend = "native" if device_prep else "numpy"
    conf = dict(embedx_dim=4, cvm_offset=3, embedx_threshold=1.0,
                initial_range=0.05, seed=3, learning_rate=0.05)
    conf.update(kw)
    jt, pt = pair(dtype, backend=backend, capacity=1024, **conf)
    if device_prep:
        jt.prepopulate(100)
        carry(jt, pt)
    tkw = dict(dense_optimizer="adam", dense_learning_rate=1e-3, bf16=bf16)
    jmodel = FlaxDeepFM(hidden=HIDDEN, **(
        {"dtype": jnp.bfloat16} if model_dtype == "bf16" else {}))
    jfs = JaxStep(jmodel, jt, JaxTrainerConfig(**tkw), B, S, dense_dim=DD,
                  num_auc_buckets=1 << 10, device_prep=device_prep)
    jp, jo = jfs.init(jax.random.PRNGKey(0))
    model = build_model("DeepFM", {"hidden": list(HIDDEN)},
                        S * pt.layout.grad_dim + DD)
    if model_dtype == "bf16":
        model = build_model("DeepFM", {"hidden": list(HIDDEN),
                                       "dtype": torch.bfloat16},
                            S * pt.layout.grad_dim + DD)
    load_flax_leaves(model, leaves_of(jp))
    pfs = FusedTrainStep(model, pt, TrainerConfig(**tkw), B, S,
                         dense_dim=DD, num_auc_buckets=1 << 10,
                         device_prep=device_prep)
    return (jfs, jt, [jp, jo, jfs.init_auc_state()]), \
        (pfs, pt, [*pfs.init(), pfs.init_auc_state()])


needs_native = pytest.mark.skipif(not ref_native.available(),
                                  reason="native backend unavailable")


@pytest.mark.parametrize("device_prep", [
    False, pytest.param(True, marks=needs_native)])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_fused_steps_match_reference(dtype, device_prep):
    """Three ``FusedTrainStep`` steps over an int8 or bf16 arena, host prep
    (``__call__``, numpy index) and device prep (``step_device``, native
    single map and its mirror; keys past the 100 prepopulated rows are
    inserted first): losses, preds, dense params and every row."""
    (jfs, jt, js), (pfs, pt, ps) = step_worlds(dtype, device_prep)
    for batch in make_batches(5, 3):
        if device_prep:
            *js, jloss, jpreds = jfs.step_device(*js, *batch)
            *ps, loss, preds = pfs.step_device(*ps, *batch)
        else:
            *js, jloss, jpreds = jfs(*js, *batch)
            *ps, loss, preds = pfs(*ps, *batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds),
                                   rtol=0, atol=1e-5)
    for got, want in zip(flax_leaves_from_model(ps[0]), leaves_of(js[0])):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert len(pt) == len(jt) > 0
    np.testing.assert_array_equal(pt.row_keys()[1:],
                                  jt._index.dump_keys(jt._size)[1:])
    assert_arenas_close(pt, jt, atol=1e-5, scale_rtol=1e-5)
    assert not bool(pfs.bad_flag)
    keys, segs, cvm, _, dense, _ = make_batches(6, 1)[0]
    np.testing.assert_allclose(
        pfs.predict(ps[0], keys, segs, cvm, dense).numpy(),
        np.asarray(jfs.predict(js[0], keys, segs, cvm, dense)),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_variable_fused_steps_match_reference(dtype):
    """The variable layout (``examples/08``'s widths) under
    ``FusedTrainStep``: three host-prep steps, every row's size code and
    arena, losses and dense params."""
    (jfs, jt, js), (pfs, pt, ps) = step_worlds(dtype, False, **dict(
        VAR, embedx_threshold=0.0))
    for batch in make_batches(7, 3):
        *js, jloss, _ = jfs(*js, *batch)
        *ps, loss, _ = pfs(*ps, *batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for got, want in zip(flax_leaves_from_model(ps[0]), leaves_of(js[0])):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert_arenas_close(pt, jt, atol=1e-5, scale_rtol=1e-5)
    # a row whose keys sat in masked rows only got no grad and stays
    # unclaimed (the codes equal the reference's, above)
    codes = pt.state[1:len(pt) + 1, pt.layout.size_col]
    assert int((codes > 0).sum()) > 0.9 * len(pt)


# -- bf16 dense compute --------------------------------------------------------

FLAX = {"DeepFM": (FlaxDeepFM, {"hidden": (16, 8)}),
        "WideDeep": (FlaxWideDeep, {"hidden": (16, 8)}),
        "FeedDNN": (FlaxFeedDNN, {"hidden": (16, 8)}),
        "MMoE": (FlaxMMoE, {"num_tasks": 2, "num_experts": 3,
                            "expert_hidden": (8,), "expert_out": 4,
                            "tower_hidden": (4,)})}


@pytest.mark.parametrize("name", sorted(FLAX))
def test_bf16_models_match_flax(name):
    """A model of ``dtype`` bfloat16 (float32 master weights) against the
    flax model of ``dtype=jnp.bfloat16`` with the same weights: float32
    logits within rtol 2^-6, atol 2^-8; float32 params kept."""
    cls, kw = FLAX[name]
    rng = np.random.default_rng(8)
    sparse = (rng.normal(size=(B, S, 11)) * 0.5).astype(np.float32)
    sparse[..., 0] = np.log1p(rng.integers(0, 9, size=(B, S)))
    dense = rng.normal(size=(B, DD)).astype(np.float32)
    fmodel = cls(dtype=jnp.bfloat16, **kw)
    params = fmodel.init(jax.random.PRNGKey(2), sparse, dense)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    leaves = [(rng.normal(size=np.shape(x)) * 0.3).astype(np.float32)
              for x in leaves]
    params = jax.tree_util.tree_unflatten(treedef, leaves)
    want = np.asarray(fmodel.apply(params, sparse, dense))
    assert want.dtype == np.float32
    model = build_model(name, {k: list(v) if isinstance(v, tuple) else v
                               for k, v in kw.items()} |
                        {"dtype": torch.bfloat16}, S * 11 + DD)
    load_flax_leaves(model, leaves)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    got = model(torch.from_numpy(sparse), torch.from_numpy(dense))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=BF16_RTOL,
                               atol=BF16_ATOL)
    # float32 by default, and the float32 model matches flax's float32;
    # the bfloat16 model's logits are not the float32 model's
    f32 = build_model(name, {k: list(v) if isinstance(v, tuple) else v
                             for k, v in kw.items()}, S * 11 + DD)
    load_flax_leaves(f32, leaves)
    f32_out = f32(torch.from_numpy(sparse),
                  torch.from_numpy(dense)).detach().numpy()
    np.testing.assert_allclose(
        f32_out, np.asarray(cls(**kw).apply(params, sparse, dense)),
        rtol=1e-5, atol=1e-6)
    assert not np.allclose(got.detach().numpy(), f32_out, rtol=1e-5,
                           atol=1e-6)


@pytest.mark.parametrize("model_dtype", ["f32", "bf16"])
def test_bf16_steps_match_reference(model_dtype):
    """``TrainerConfig(bf16=True)``: the pooled features and dense inputs
    cast to bfloat16 before the model, its logits back to float32, in
    both packages. Over a float32 model (the reference's default) that
    rounds the inputs only: losses rtol 1e-5 and rows as in float32. Over
    a bfloat16 model: losses within rtol 2^-6."""
    (jfs, jt, js), (pfs, pt, ps) = step_worlds(
        "f32", False, bf16=True, model_dtype=model_dtype)
    assert pfs.compute_dtype == torch.bfloat16
    rtol = 1e-5 if model_dtype == "f32" else BF16_RTOL
    for batch in make_batches(9, 3):
        *js, jloss, _ = jfs(*js, *batch)
        *ps, loss, _ = pfs(*ps, *batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=rtol)
    if model_dtype == "f32":
        assert_arenas_close(pt, jt, atol=1e-5)
        for got, want in zip(flax_leaves_from_model(ps[0]),
                             leaves_of(js[0])):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("model_dtype", ["f32", "bf16"])
def test_train_step_ignores_bf16_as_reference(model_dtype):
    """The host engine's ``TrainStep`` under ``bf16=True`` ignores the
    flag, as the reference's ``TrainStep`` does: the model takes float32
    inputs. Three steps against the reference's ``TrainStep(bf16=True)``
    (a plain one: no cast added) from the same weights: over a float32
    model, loss, preds, ``predict``, demb and the dense params within
    1e-5 and demb's show/clk exact, and every output bit for bit the
    port's ``bf16=False`` step; over a model of ``dtype`` bfloat16 (which
    casts its float32 inputs itself, as flax's does), the same within the
    bfloat16 tolerances."""
    from paddlebox_tpu.trainer.train_step import TrainStep as JaxTrainStep
    from paddlebox_tpu_torch.trainer.train_step import TrainStep
    conf = TableConfig(embedx_dim=8, cvm_offset=3)
    rng = np.random.default_rng(3)
    batches = make_batches(3, 3)
    emb = (rng.normal(size=(NPAD, 11)) * 0.3).astype(np.float32)
    emb[:, :2] = np.abs(emb[:, :2]) * 5
    tkw = dict(bf16=True, dense_optimizer="sgd", dense_learning_rate=0.05)
    bf16_model = model_dtype == "bf16"
    flax_kw = {"dtype": jnp.bfloat16} if bf16_model else {}
    jstep = JaxTrainStep(
        FlaxDeepFM(hidden=HIDDEN, **flax_kw),
        JaxTableConfig(embedx_dim=8, cvm_offset=3),
        JaxTrainerConfig(**tkw), B, S, DD)
    jparams, jopt = jstep.init(jax.random.PRNGKey(2))
    jauc = jstep.init_auc_state()
    rtol, atol = (BF16_RTOL, BF16_ATOL) if bf16_model else (1e-5, 1e-6)
    out = {}
    for bf16 in (True, False):
        model = build_model(
            "DeepFM", {"hidden": list(HIDDEN),
                       **({"dtype": torch.bfloat16} if bf16_model else {})},
            S * 11 + DD)
        load_flax_leaves(model, leaves_of(jparams))
        step = TrainStep(model, conf, TrainerConfig(**{**tkw, "bf16": bf16}),
                         B, S, DD, device="cpu")
        params, opt = step.init()
        auc = step.init_auc_state()
        out[bf16] = []
        for keys, segs, cvm, labels, dense, mask in batches:
            params, opt, auc, demb, loss, preds = step(
                params, opt, auc, emb, segs, cvm, labels, dense, mask)
            out[bf16].append((demb, float(loss), preds.numpy(),
                              step.predict(params, emb, segs, cvm,
                                           dense).numpy()))
        out[bf16].append(flax_leaves_from_model(params))
    for (keys, segs, cvm, labels, dense, mask), got in zip(batches,
                                                           out[True]):
        jparams, jopt, jauc, jdemb, jloss, jpreds = jstep(
            jparams, jopt, jauc, emb, segs, cvm, labels, dense, mask)
        jdemb = np.asarray(jdemb)
        np.testing.assert_array_equal(got[0][:, :2], jdemb[:, :2])
        np.testing.assert_allclose(got[0], jdemb, rtol=rtol, atol=atol)
        np.testing.assert_allclose(got[1], float(jloss), rtol=rtol)
        np.testing.assert_allclose(got[2], np.asarray(jpreds), rtol=rtol,
                                   atol=atol)
        np.testing.assert_allclose(got[3], np.asarray(jstep.predict(
            jparams, emb, segs, cvm, dense)), rtol=rtol, atol=atol)
    for got, want in zip(out[True][-1], leaves_of(jparams)):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    # the flag changes nothing in the host step
    for a, b in zip(out[True][:-1], out[False][:-1]):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])
    for a, b in zip(out[True][-1], out[False][-1]):
        np.testing.assert_array_equal(a, b)


# -- the numeric-sentinel hook -------------------------------------------------

def test_sentinel_hook_fires_once_a_dispatch():
    """``set_sentinel(cb)``: one call a dispatch with its step count, its
    sentinel(s) and loss(es) as tensors (a step: scalars; a chunk or a
    run: [k]); ``cb=None`` clears it."""
    (_, _, _), (pfs, pt, ps) = step_worlds("int8", False)
    calls = []
    pfs.set_sentinel(lambda k, bad, loss: calls.append(
        (k, tuple(bad.shape), tuple(loss.shape), bool(bad.any()))))
    batches = make_batches(10, 6)
    *ps, _, _ = pfs(*ps, *batches[0])
    assert calls == [(1, (), (), False)]
    *ps, losses, _ = pfs.train_chunk(*ps, *map(list, zip(*batches[:3])))
    assert calls[1] == (3, (3,), (3,), False)
    *ps, _, steps = pfs.train_stream(*ps, iter(batches[3:]))
    assert steps == 3 and calls[2:] == [(1, (), (), False)] * 3
    pfs.set_sentinel(None)
    pfs(*ps, *batches[0])
    assert len(calls) == 5


@needs_native
def test_sentinel_hook_on_device_prep_runs():
    """Device prep: ``step_device`` calls the hook once; a run of
    ``DEV_CHUNK`` steps (eager on the CPU) once with k = 16."""
    (_, _, _), (pfs, pt, ps) = step_worlds("bf16", True)
    calls = []
    pfs.set_sentinel(lambda k, bad, loss: calls.append(
        (k, tuple(bad.shape), tuple(loss.shape))))
    batches = make_batches(11, pfs.DEV_CHUNK + 1, vocab=90)
    *ps, _, _ = pfs.step_device(*ps, *batches[0])
    *ps, _, steps = pfs.train_stream(*ps, iter(batches[1:]))
    assert steps == pfs.DEV_CHUNK
    assert calls == [(1, (), ()), (16, (16,), (16,))]


# -- the trainer and the bundles -----------------------------------------------

def feed_confs():
    jconf = JaxFeedConfig(slots=[
        JaxSlotConfig("label", type="float", is_dense=True, dim=1),
        JaxSlotConfig("slot_a"), JaxSlotConfig("slot_b"),
        JaxSlotConfig("slot_c"),
        JaxSlotConfig("dense_x", type="float", is_dense=True, dim=3),
    ], batch_size=8, label_slot="label", thread_num=2)
    return jconf, DataFeedConfig.from_dict(dataclasses.asdict(jconf))


TRAINER_TABLE = dict(embedx_dim=4, cvm_offset=3, optimizer="adagrad",
                     learning_rate=0.05, embedx_threshold=0.0, seed=2)


@pytest.mark.parametrize("dtype,device_prep", [
    pytest.param("int8", True, marks=needs_native), ("bf16", False)])
def test_trainer_pass_matches_reference(tmp_path, dtype, device_prep):
    """``CTRTrainer(table=<int8 or bf16 DeviceTable>)``: a
    ``train_from_dataset`` pass (device prep over int8, host prep over
    bf16) against the reference trainer over the same arena, then
    ``train_from_files`` over the same files on a twin equal to the
    dataset pass by key, and ``evaluate``."""
    jfeed, feed = feed_confs()
    files = [make_slot_file(str(tmp_path / f"part-{i}"), jfeed, 48, seed=i)
             for i in range(2)]
    jd, pd = DTYPES[dtype]
    jt = JaxDeviceTable(JaxTableConfig(**TRAINER_TABLE), capacity=4096,
                        backend="native", index_threads=1, value_dtype=jd)
    arena = (np.asarray(jt.values, np.float32).copy(),
             np.asarray(jt.state).copy(), jt._index.dump_keys(jt._size))
    jtr = ref_trainer.CTRTrainer(
        FlaxDeepFM(hidden=(16,)), jfeed, JaxTableConfig(**TRAINER_TABLE),
        JaxTrainerConfig(), table=jt, device_prep=device_prep)
    init = leaves_of(jtr.params)
    jds = JaxSlotDataset(jfeed)
    jds.set_filelist(files)
    jds.load_into_memory()
    want = jtr.train_from_dataset(jds)

    def port_trainer():
        t = DeviceTable(TableConfig(**TRAINER_TABLE), capacity=1,
                        device="cpu", backend="native", index_threads=1,
                        value_dtype=pd)
        t.load_arena(*arena)
        return CTRTrainer(deepfm_from_flax_leaves(init, (16,)), feed,
                          TableConfig(**TRAINER_TABLE), TrainerConfig(),
                          table=t, device_prep=device_prep)

    tr = port_trainer()
    assert tr.step.device_prep == device_prep
    ds = SlotDataset(feed)
    ds.set_filelist(files)
    ds.load_into_memory()
    got = tr.train_from_dataset(ds)
    assert got["ins_num"] == want["ins_num"] == 96
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
    for g, w in zip(flax_leaves_from_model(tr.params), leaves_of(jtr.params)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    assert_arenas_close(tr.table, jt, atol=1e-5, scale_rtol=1e-5)
    ev = tr.evaluate(ds)
    assert ev["ins_num"] == 96 and 0.0 <= ev["auc"] <= 1.0
    if device_prep:
        files_tr = port_trainer()
        files_tr.train_from_files(files, buckets=BucketSpec(min_size=64))
        a, b = files_tr.table.snapshot(), tr.table.snapshot()
        oa, ob = np.argsort(a["keys"]), np.argsort(b["keys"])
        for f in ("keys", "values", "state"):
            np.testing.assert_array_equal(a[f][oa], b[f][ob])


def test_bf16_model_bundle_serves_in_float32_in_both_packages(tmp_path):
    """A bundle of a model trained with ``dtype`` bfloat16 records no
    dtype; both packages' predictors build it in float32 and score alike,
    the port's bundle (an int8 table's canonical snapshot) and the
    reference's (a flax ``DeepFM(dtype=jnp.bfloat16)``) each way."""
    data = str(tmp_path / "c.txt")
    criteo.make_synthetic_criteo(data, 48, seed=5, vocab_per_slot=40)
    conf = dict(embedx_dim=8, cvm_offset=3, embedx_threshold=0.0, seed=7,
                initial_range=0.05)
    batches = list(criteo.CriteoReader(B).stream([data]))
    keys = np.unique(np.concatenate([b.keys[:b.num_keys] for b in batches]))
    table = DeviceTable(TableConfig(**conf), capacity=keys.size + 1,
                        device="cpu", backend="numpy",
                        value_dtype=torch.int8)
    table.prepare_batch(keys)
    snap = table.snapshot()
    snap["embedx_ok"] = snap["values"][:, 0] >= 0.0
    rng = np.random.default_rng(6)
    model = build_model("DeepFM", {"hidden": [16], "dtype": torch.bfloat16},
                        26 * 11 + 13)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(np.asarray(
                rng.normal(size=p.shape) * 0.1, dtype=np.float32)))
    feed = criteo.criteo_feed_config(B)
    port_bundle = save_inference_model(str(tmp_path / "port"), model, snap,
                                       feed, TableConfig(**conf))
    fmodel = FlaxDeepFM(hidden=(16,), dtype=jnp.bfloat16)
    params = fmodel.init(jax.random.PRNGKey(0),
                         np.zeros((B, 26, 11), np.float32),
                         np.zeros((B, 13), np.float32))
    jtable = JaxTable(JaxTableConfig(**conf))
    jtable.import_rows(snap["keys"], snap["values"],
                       np.zeros((keys.size, 2), np.float32))
    jax_bundle = jax_save(str(tmp_path / "jax"), fmodel, params, jtable,
                          feed_jax(), JaxTableConfig(**conf))
    for bundle in (port_bundle, jax_bundle):
        with open(os.path.join(bundle, "model.json")) as f:
            assert "dtype" not in json.load(f)["model"]["kwargs"]
        pp = CTRPredictor(bundle, device="cpu")
        assert pp.model.dtype == torch.float32
        jp = JaxPredictor(bundle)
        got = np.concatenate([pp.predict_batch(b) for b in batches])
        want = np.concatenate([jp.predict_batch(b) for b in
                               jax_batches(data)])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def feed_jax():
    from paddlebox_tpu.data import criteo as jax_criteo
    return jax_criteo.criteo_feed_config(B)


def jax_batches(data):
    from paddlebox_tpu.data import criteo as jax_criteo
    return list(jax_criteo.CriteoReader(B).stream([data]))


@needs_native
def test_pass_loop_over_int8_matches_reference(tmp_path):
    """``PassManager`` over ``SparsePS`` over an int8 table (device prep),
    ``tests/test_torch_pass_manager.py``'s loop (steps, two passes with a
    preload and deltas, a base, a day-2 pass of new keys), against the
    reference's over its int8 table from the same arena and weights: the
    donefile records and every npz of the trail in the canonical float32
    layout (keys exact; show/clk exact; values within a quantum of their
    row; the rest 1e-5); the port's trail resumed by both packages into
    float32 tables gives the same rows."""
    import test_torch_pass_manager as tpm
    from paddlebox_tpu.ps.server import SparsePS as RefSparsePS
    from paddlebox_tpu.trainer.pass_manager import \
        PassManager as RefPassManager
    from paddlebox_tpu_torch.trainer import donefile
    files = [make_slot_file(str(tmp_path / f"part-{i}"), tpm.jax_feed_conf(),
                            24, seed=10 + i, vocab=v)
             for i, v in enumerate((tpm.PREPOP,) * 3 + (900,))]
    jt = JaxDeviceTable(JaxTableConfig(**tpm.TABLE), capacity=tpm.CAPACITY,
                        backend="native", index_threads=1,
                        value_dtype=jnp.int8)
    jt.prepopulate(tpm.PREPOP)
    arena = (np.asarray(jt.values, np.float32).copy(),
             np.asarray(jt.state).copy(), jt._index.dump_keys(jt._size))
    jtr = ref_trainer.CTRTrainer(
        FlaxDeepFM(hidden=tpm.HIDDEN), tpm.jax_feed_conf(),
        JaxTableConfig(**tpm.TABLE), JaxTrainerConfig(), table=jt)
    init = leaves_of(jtr.params)
    roots = {k: str(tmp_path / k) for k in ("ref", "port")}
    jpm = RefPassManager(RefSparsePS({"embedding": jt}), roots["ref"],
                         [JaxSlotDataset(tpm.jax_feed_conf()),
                          JaxSlotDataset(tpm.jax_feed_conf())])
    tpm.drive(jpm, jtr, files)
    jpm.close()
    pt = DeviceTable(TableConfig(**tpm.TABLE), capacity=1, device="cpu",
                     backend="native", index_threads=1,
                     value_dtype=torch.int8)
    pt.load_arena(*arena)
    tr = CTRTrainer(deepfm_from_flax_leaves(init, tpm.HIDDEN),
                    tpm.port_feed_conf(), TableConfig(**tpm.TABLE),
                    TrainerConfig(), table=pt)
    ppm = tpm.port_pm(pt, roots["port"])
    tpm.drive(ppm, tr, files)
    ppm.close()
    recs = [tpm.records(roots[k]) for k in ("port", "ref")]
    assert recs[0] == recs[1] and len(recs[0]) == 4
    for rec in donefile.read_done(roots["port"]):
        rel = os.path.relpath(rec["path"], roots["port"])
        name = os.path.join(rel, "embedding.npz")
        with np.load(os.path.join(roots["port"], name)) as got, \
                np.load(os.path.join(roots["ref"], name)) as want:
            np.testing.assert_array_equal(got["keys"], want["keys"])
            gv, wv = got["values"], want["values"]
            assert gv.dtype == np.float32
            np.testing.assert_array_equal(gv[:, :2], wv[:, :2])
            quantum = np.abs(wv[:, 2:]).max(axis=1, keepdims=True) / 127.0
            assert np.all(np.abs(gv[:, 2:] - wv[:, 2:]) <=
                          quantum * 1.001 + 1e-5)
            np.testing.assert_allclose(got["state"], want["state"],
                                       rtol=1e-5, atol=1e-6)
    model = build_model("DeepFM", {"hidden": list(tpm.HIDDEN)}, 3 * 7 + 3)
    template = (model, tpm.make_dense_optimizer(TrainerConfig()).init(model))
    resumed = DeviceTable(TableConfig(**tpm.TABLE), capacity=1,
                          device="cpu", backend="native", index_threads=1)
    pm = tpm.port_pm(resumed, roots["port"])
    assert pm.resume(dense_template=template)[:2] == (tpm.DAY2, 3)
    pm.close()
    jresumed = JaxDeviceTable(JaxTableConfig(**tpm.TABLE),
                              capacity=tpm.CAPACITY, backend="native",
                              index_threads=1)
    jpm = RefPassManager(RefSparsePS({"embedding": jresumed}), roots["port"],
                         [JaxSlotDataset(tpm.jax_feed_conf())])
    jpm.resume(dense_template=(jtr.params, jtr.opt_state))
    jpm.close()
    for a, b in zip(tpm.port_rows(resumed), tpm.ref_rows(jresumed)):
        np.testing.assert_array_equal(a, b)
