"""Serving parity: bundles cross between the JAX package and the port, and
both predictors score the same Criteo lines alike (atol=1e-5, float32
GEMMs in another order). The table pull is bit-identical."""

import json
import os
import shutil

import jax
import numpy as np
import pytest

from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.data import criteo as jax_criteo
from paddlebox_tpu.data.record import SlotRecord as JaxSlotRecord
from paddlebox_tpu.inference.predictor import CTRPredictor as JaxPredictor
from paddlebox_tpu.inference.predictor import \
    save_inference_model as jax_save
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.ps.table import EmbeddingTable as JaxTable
from paddlebox_tpu_torch.config import TableConfig
from paddlebox_tpu_torch.data import criteo
from paddlebox_tpu_torch.data.record import SlotRecord
from paddlebox_tpu_torch.inference.predictor import (CTRPredictor,
                                                     save_inference_model)
from paddlebox_tpu_torch.models.convert import deepfm_from_flax_leaves
from paddlebox_tpu_torch.ps.table import EmbeddingTable

B = 32
HIDDEN = (16, 8)
ATOL = 1e-5
TABLE = dict(embedx_dim=8, cvm_offset=3, embedx_threshold=10.0, seed=7)


def _rows(rng, n):
    values = (rng.normal(size=(n, 11)) * 0.1).astype(np.float32)
    show = rng.integers(0, 21, size=n)
    values[:, 0] = show
    values[:, 1] = np.floor(show * rng.uniform(0, 0.3, size=n))
    return values


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A Criteo file, and a bundle exported by the JAX package whose table
    holds ~70% of the file's keys (some gated) plus high-bit keys."""
    root = tmp_path_factory.mktemp("serve")
    data = str(root / "criteo.txt")
    jax_criteo.make_synthetic_criteo(data, 80, seed=3, vocab_per_slot=50)
    rng = np.random.default_rng(11)
    file_keys = np.unique(np.concatenate(
        [b.keys[:b.num_keys]
         for b in jax_criteo.CriteoReader(B).stream([data])]))
    known = file_keys[rng.uniform(size=file_keys.size) < 0.7]
    high = (np.uint64(1) << np.uint64(63)) | rng.integers(
        1, 1 << 40, size=20).astype(np.uint64)
    keys = np.concatenate([known, high])
    values = _rows(rng, keys.size)
    conf = JaxTableConfig(**TABLE)
    table = JaxTable(conf)
    table.import_rows(keys, values, np.zeros((keys.size, 2), np.float32))
    model = FlaxDeepFM(hidden=HIDDEN)
    params = model.init(jax.random.PRNGKey(0),
                        np.zeros((B, 26, 11), np.float32),
                        np.zeros((B, 13), np.float32))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    leaves = [(rng.normal(size=np.shape(x)) * 0.2).astype(np.float32)
              for x in leaves]
    params = jax.tree_util.tree_unflatten(treedef, leaves)
    bundle = jax_save(str(root / "jax_bundle"), model, params, table,
                      jax_criteo.criteo_feed_config(B), conf,
                      version="day1/pass2")
    return dict(root=root, data=data, bundle=bundle, keys=keys,
                file_keys=file_keys, table=table, leaves=leaves, rng=rng)


def _scores_both(bundle, data):
    jax_pred = JaxPredictor(bundle)
    port_pred = CTRPredictor(bundle, device="cpu")
    want = np.concatenate([jax_pred.predict_batch(b) for b in
                           jax_criteo.CriteoReader(B).stream([data])])
    got = np.concatenate([port_pred.predict_batch(b) for b in
                          criteo.CriteoReader(B).stream([data])])
    return got, want


def test_pull_is_bit_identical(world):
    keys = np.concatenate([world["keys"], world["file_keys"],
                           np.array([0, 0, 12345], np.uint64)])
    np.random.default_rng(0).shuffle(keys)
    want = world["table"].pull(keys, create=False)
    port = EmbeddingTable(TableConfig(**TABLE), device="cpu")
    port.load(os.path.join(world["bundle"], "table.npz"))
    got = port.pull(keys).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # the sample covers every rule: unknown, key 0, gated and open rows
    assert (~want.any(axis=1)).sum() > 3
    gated = want[:, 0] < 10
    assert (gated & want[:, 2].astype(bool)).any()
    assert not want[gated, 3:].any() and want[~gated, 3:].any()


def test_scores_match_jax_predictor(world):
    got, want = _scores_both(world["bundle"], world["data"])
    assert got.shape == want.shape == (80,)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _records(cls, rng_seed, keys, n):
    rng = np.random.default_rng(rng_seed)
    out = []
    for i in range(n):
        r = cls()
        lens = rng.integers(0, 3, size=26)
        r.uint64_feas = rng.choice(keys, size=int(lens.sum()))
        r.uint64_offsets = np.concatenate([[0], np.cumsum(lens)]).astype(
            np.int64)
        r.float_feas = rng.normal(size=13).astype(np.float32)
        r.float_offsets = np.array([0, 13], np.int64)
        r.label = float(i % 2)
        out.append(r)
    return out


def test_predict_records_match_jax_predictor(world):
    pool = np.concatenate([world["file_keys"], world["keys"][-5:],
                           np.array([777, 0], np.uint64)])
    want = JaxPredictor(world["bundle"]).predict_records(
        _records(JaxSlotRecord, 4, pool, 45))
    pred = CTRPredictor(world["bundle"], device="cpu")
    got = pred.predict_records(_records(SlotRecord, 4, pool, 45))
    assert got.shape == (45,)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert pred.model_version == "day1/pass2"
    assert pred.predict_records([]).shape == (0,)


def test_port_bundle_serves_alike_in_jax(world):
    rng = world["rng"]
    model = deepfm_from_flax_leaves(world["leaves"], HIDDEN)
    keys = world["keys"]
    snap = {"keys": keys, "values": _rows(rng, keys.size),
            "state": np.zeros((keys.size, 2), np.float32),
            "embedx_ok": rng.uniform(size=keys.size) < 0.6}
    out = save_inference_model(str(world["root"] / "port_bundle"), model,
                               snap, criteo.criteo_feed_config(B),
                               TableConfig(**TABLE), version="day1/pass2")
    with open(os.path.join(out, "model.json")) as f, \
            open(os.path.join(world["bundle"], "model.json")) as g:
        assert json.load(f) == json.load(g)
    got, want = _scores_both(out, world["data"])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_snapshot_validation(world, tmp_path):
    model = deepfm_from_flax_leaves(world["leaves"], HIDDEN)
    snap = {"keys": np.arange(1, 5, dtype=np.uint64),
            "values": np.zeros((4, 11), np.float32),
            "state": np.zeros((4, 1), np.float32),
            "embedx_ok": np.ones(4, bool)}
    with pytest.raises(ValueError, match="state"):
        save_inference_model(str(tmp_path / "b"), model, snap,
                             criteo.criteo_feed_config(B),
                             TableConfig(**TABLE))


def test_quantized_only_bundle_and_create_raise(world, tmp_path):
    bundle = str(tmp_path / "q8")
    shutil.copytree(world["bundle"], bundle)
    os.rename(os.path.join(bundle, "table.npz"),
              os.path.join(bundle, "table.q8.npz"))
    with pytest.raises(NotImplementedError, match="q8"):
        CTRPredictor(bundle, device="cpu")
    table = EmbeddingTable(TableConfig(**TABLE), device="cpu")
    with pytest.raises(NotImplementedError, match="training"):
        table.pull(np.array([1], np.uint64), create=True)


def test_synthetic_criteo_is_byte_identical(tmp_path):
    a, b = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    jax_criteo.make_synthetic_criteo(a, 100, seed=5)
    criteo.make_synthetic_criteo(b, 100, seed=5)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()
    pairs = list(zip(jax_criteo.CriteoReader(32).stream([a]),
                     criteo.CriteoReader(32).stream([b])))
    assert len(pairs) == 4
    for x, y in pairs:
        for field in ("keys", "segment_ids", "lengths", "labels", "dense"):
            np.testing.assert_array_equal(getattr(x, field),
                                          getattr(y, field))
        for field in ("batch_size", "num_slots", "num_keys", "num_rows"):
            assert getattr(x, field) == getattr(y, field)


def test_reader_names_the_bad_line(tmp_path):
    path = str(tmp_path / "bad.txt")
    criteo.make_synthetic_criteo(path, 5, seed=1)
    with open(path) as f:
        lines = f.readlines()
    lines[2] = "1\t2\t3\n"
    with open(path, "w") as f:
        f.writelines(lines)
    with pytest.raises(ValueError, match="bad.txt:3"):
        list(criteo.CriteoReader(4).stream([path]))


def test_batch_assembler_matches_jax():
    from paddlebox_tpu.data.batch import BatchAssembler as JaxAssembler
    from paddlebox_tpu_torch.data.batch import BatchAssembler
    keys = np.arange(1, 200, dtype=np.uint64) << np.uint64(20)
    want = JaxAssembler(jax_criteo.criteo_feed_config(B)).assemble(
        _records(JaxSlotRecord, 9, keys, 20))
    got = BatchAssembler(criteo.criteo_feed_config(B)).assemble(
        _records(SlotRecord, 9, keys, 20))
    for field in ("keys", "segment_ids", "lengths", "labels", "dense",
                  "search_ids"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert (got.num_keys, got.num_rows) == (want.num_keys, want.num_rows)
