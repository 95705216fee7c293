"""The port's embedded serving export on the CPU
(``inference/export_embedded.py``) against the reference's
``export_stablehlo_bundle``: the same bundle, exported by the JAX package,
through both, for DeepFM and for ``examples/08``'s WideDeep: the key file
and the manifest byte for byte, the value file within 1e-6, and the
loader's path in Python (the key file's lookup, the plain seqpool, then
``dense_fwd.ep.pt2``) against the reference's ``dense_fwd.jaxexport`` on
the same inputs and against both packages' predictors, within the
reference's rtol 2e-5, atol 1e-6. The C++ loader (``csrc/pbx_serve.cpp``)
builds against the CUDA toolkit and runs on the card only:
``chip_smoke.py`` phase 4s holds it to ``CTRPredictor`` there."""

import os

import jax
import numpy as np
import pytest
import torch
from jax import export as jexport

from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.data import criteo as jax_criteo
from paddlebox_tpu.inference.export_hlo import export_stablehlo_bundle
from paddlebox_tpu.inference.predictor import CTRPredictor as JaxPredictor
from paddlebox_tpu.inference.predictor import \
    save_inference_model as jax_save
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.models import WideDeep as FlaxWideDeep
from paddlebox_tpu.ps.table import EmbeddingTable as JaxTable
from paddlebox_tpu_torch.config import DataFeedConfig, SlotConfig
from paddlebox_tpu_torch.data import criteo
from paddlebox_tpu_torch.inference import CTRPredictor
from paddlebox_tpu_torch.inference.export_embedded import (
    AOTI_FILE, EP_FILE, export_embedded_bundle, line_groups)
from paddlebox_tpu_torch.ops.seqpool_kernel import seqpool_cvm_plain

B = 32
S = 26
NPAD = 2048
# examples/08's table: embedx 4, cvm_offset 3, no gating threshold; and a
# gated one
TABLES = {"DeepFM": dict(embedx_dim=8, cvm_offset=3, embedx_threshold=10.0,
                         seed=7),
          "WideDeep": dict(embedx_dim=4, cvm_offset=3, embedx_threshold=0.0,
                           seed=1)}
MODELS = {"DeepFM": FlaxDeepFM, "WideDeep": FlaxWideDeep}


@pytest.fixture(scope="module", params=sorted(MODELS))
def world(request, tmp_path_factory):
    """A Criteo file, a bundle the JAX package exports (~70% of the file's
    keys, some gated, high-bit keys, a zero key), and both exports."""
    kind = request.param
    root = tmp_path_factory.mktemp(f"embedded_{kind}")
    data = str(root / "criteo.txt")
    jax_criteo.make_synthetic_criteo(data, 2 * B, seed=3, vocab_per_slot=50)
    rng = np.random.default_rng(11)
    batches = list(jax_criteo.CriteoReader(B).stream([data]))
    file_keys = np.unique(np.concatenate([b.keys[:b.num_keys]
                                          for b in batches]))
    known = file_keys[rng.uniform(size=file_keys.size) < 0.7]
    high = (np.uint64(1) << np.uint64(63)) | rng.integers(
        1, 1 << 40, size=20).astype(np.uint64)
    keys = rng.permutation(np.concatenate([known, high, [np.uint64(0)]]))
    conf = JaxTableConfig(**TABLES[kind])
    values = (rng.normal(size=(keys.size, conf.pull_dim)) * 0.1).astype(
        np.float32)
    show = rng.integers(0, 21, size=keys.size)
    values[:, 0] = show
    values[:, 1] = np.floor(show * rng.uniform(0, 0.3, size=keys.size))
    table = JaxTable(conf)
    table.import_rows(keys, values, np.zeros((keys.size, 2), np.float32))
    model = MODELS[kind](hidden=(16,))
    params = model.init(jax.random.PRNGKey(0),
                        np.zeros((B, S, conf.pull_dim), np.float32),
                        np.zeros((B, 13), np.float32))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    leaves = [(rng.normal(size=np.shape(x)) * 0.2).astype(np.float32)
              for x in leaves]
    params = jax.tree_util.tree_unflatten(treedef, leaves)
    bundle = jax_save(str(root / "bundle"), model, params, table,
                      jax_criteo.criteo_feed_config(B), conf)
    ref = export_stablehlo_bundle(bundle, str(root / "ref"), npad=NPAD)
    port = export_embedded_bundle(bundle, str(root / "port"), npad=NPAD,
                                  device="cpu")
    return dict(kind=kind, data=data, bundle=bundle, ref=ref, port=port)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_table_and_manifest_match_reference(world):
    ref, port = world["ref"], world["port"]
    assert _read(os.path.join(port, "table.keys.u64")) == \
        _read(os.path.join(ref, "table.keys.u64"))
    assert _read(os.path.join(port, "manifest.txt")) == \
        _read(os.path.join(ref, "manifest.txt"))
    got = np.fromfile(os.path.join(port, "table.vals.f32"), np.float32)
    want = np.fromfile(os.path.join(ref, "table.vals.f32"), np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    keys = np.fromfile(os.path.join(port, "table.keys.u64"), np.uint64)
    assert keys.all()                    # the padding key is not exported
    pull_dim = TABLES[world["kind"]]["embedx_dim"] + 3
    assert _read(os.path.join(port, "manifest.txt")).decode() == (
        f"npad={NPAD}\nbatch={B}\nslots={S}\npull_dim={pull_dim}\n"
        f"dense_dim=13\nrows={got.size // pull_dim}\n")
    assert _read(os.path.join(port, "layout.txt")).decode() == (
        "use_cvm=1\ncvm_offset=2\ngroups=L D13 " + " ".join(["S"] * S)
        + "\n")
    # the compiled form is the card's only
    assert os.path.exists(os.path.join(port, EP_FILE))
    assert not os.path.exists(os.path.join(port, AOTI_FILE))


def _loader_inputs(port, batch):
    """What the C++ loader builds for a batch: the key file's lookup (an
    unknown key gathers zeros), the keys padded to npad with segment id
    B*S, the dense values."""
    keys = np.fromfile(os.path.join(port, "table.keys.u64"), np.uint64)
    vals = np.fromfile(os.path.join(port, "table.vals.f32"),
                       np.float32).reshape(keys.size, -1)
    row = {int(k): i for i, k in enumerate(keys)}
    nk = batch.num_keys
    assert nk <= NPAD
    emb = np.zeros((NPAD, vals.shape[1]), np.float32)
    for i, k in enumerate(batch.keys[:nk]):
        r = row.get(int(k))
        if r is not None:
            emb[i] = vals[r]
    segs = np.full(NPAD, B * S, np.int32)
    segs[:nk] = batch.segment_ids[:nk]
    return emb, segs, batch.dense.astype(np.float32)


def test_loader_path_matches_reference_program_and_predictors(world):
    ref, port = world["ref"], world["port"]
    with open(os.path.join(ref, "dense_fwd.jaxexport"), "rb") as f:
        exp = jexport.deserialize(bytearray(f.read()))
    fwd = torch.export.load(os.path.join(port, EP_FILE)).module()
    jp = JaxPredictor(world["bundle"])
    pp = CTRPredictor(world["bundle"], device="cpu")
    for jb, pb in zip(jax_criteo.CriteoReader(B).stream([world["data"]]),
                      criteo.CriteoReader(B).stream([world["data"]])):
        emb, segs, dense = _loader_inputs(port, pb)
        want = np.asarray(exp.call(emb, segs, np.ones((B, 2), np.float32),
                                   dense))
        pooled = seqpool_cvm_plain(torch.from_numpy(emb),
                                   torch.from_numpy(segs), B, S, True, 2)
        with torch.no_grad():
            got = fwd(pooled.reshape(B, -1), torch.from_numpy(dense)).numpy()
        assert got.shape == want.shape == (B,)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
        n = pb.num_rows
        np.testing.assert_allclose(got[:n], pp.predict_batch(pb),
                                   rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(got[:n], jp.predict_batch(jb),
                                   rtol=2e-5, atol=1e-6)


def test_line_groups_follow_the_feed():
    conf = DataFeedConfig(
        slots=[SlotConfig("a"), SlotConfig("label", type="float",
                                           is_dense=True),
               SlotConfig("unused", is_used=False),
               SlotConfig("d", type="float", is_dense=True, dim=3),
               SlotConfig("gone", type="float", is_used=False)],
        parse_ins_id=True)
    assert line_groups(conf) == "X S L X D3 X"
    conf.slots.append(SlotConfig("s", type="string"))
    with pytest.raises(ValueError, match="string slot"):
        line_groups(conf)


def test_openmp_cxx_skips_a_compiler_without_openmp(tmp_path, monkeypatch):
    """AOTInductor's wrapper build passes -fopenmp: a ``$CXX`` that cannot
    build with it is passed over for ``g++``, and with neither the export
    says why."""
    from paddlebox_tpu_torch.inference import export_embedded
    fake = tmp_path / "no-openmp-g++"
    fake.write_text("#!/bin/sh\necho 'cannot read spec file libgomp.spec' "
                    ">&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    cxx = export_embedded.openmp_cxx()
    assert cxx != str(fake) and os.path.basename(cxx) == "g++"
    monkeypatch.setattr(export_embedded.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="libgomp.spec"):
        export_embedded.openmp_cxx()
