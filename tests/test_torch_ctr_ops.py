"""The port's CTR dense ops (``ops/ctr_ops.py``) and page-view batching
(``data/pv.py``) against the JAX package's, on seeded numpy inputs: every
op's forward within 1e-5 (``scaled_fc``, a bf16 product, within the
reference tests' 0.05), the gradients of ``data_norm``, ``batch_fc``,
``cross_norm_hadamard`` and ``rank_attention`` against ``jax.grad``
(``rank_attention``'s reach ``rank_param`` only), the clamped parameter
block of an instance whose own rank is above ``max_rank``, and
``PvBatchAssembler``'s batches array for array."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_slot_file
from paddlebox_tpu import ops as ref_ops
from paddlebox_tpu.config import DataFeedConfig as JaxFeedConfig
from paddlebox_tpu.config import SlotConfig as JaxSlotConfig
from paddlebox_tpu.data import pv as ref_pv
from paddlebox_tpu.data.parser import SlotParser as JaxSlotParser
from paddlebox_tpu_torch import ops
from paddlebox_tpu_torch.config import DataFeedConfig
from paddlebox_tpu_torch.data import pv
from paddlebox_tpu_torch.data.parser import SlotParser

torch.set_num_threads(1)
ATOL = 1e-5


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, tol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def rank_inputs(ranks, pv_offsets, ins, d=4, max_rank=3, para_col=5,
                seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(ins, d)).astype(np.float32)
    ro = ref_ops.build_rank_offset(np.array(ranks), np.array(pv_offsets),
                                   max_rank)
    param = rng.normal(size=(max_rank * max_rank * d,
                             para_col)).astype(np.float32)
    return x, ro, param


class TestForward:
    def test_data_norm_and_stats(self):
        rng = np.random.default_rng(0)
        x = rng.normal(size=(16, 5)).astype(np.float32)
        bsize = np.full(5, 100.0, np.float32)
        bsum = rng.normal(size=5).astype(np.float32) * 100
        bsq = np.abs(rng.normal(size=5)).astype(np.float32) * 100 + 50
        sw = rng.normal(size=5).astype(np.float32)
        bias = rng.normal(size=5).astype(np.float32)
        for extra in ((), (sw, bias)):
            close(ops.data_norm(t(x), t(bsize), t(bsum), t(bsq),
                                *map(t, extra)),
                  ref_ops.data_norm(jnp.asarray(x), jnp.asarray(bsize),
                                    jnp.asarray(bsum), jnp.asarray(bsq),
                                    *map(jnp.asarray, extra)))
        mask = (rng.random(16) < 0.6).astype(np.float32)
        for m in (None, mask):
            got = ops.data_norm_stats(t(x), None if m is None else t(m))
            want = ref_ops.data_norm_stats(
                jnp.asarray(x), None if m is None else jnp.asarray(m))
            for g, w in zip(got, want):
                close(g, w)
            upd = ops.data_norm_update_summary(
                t(bsize), t(bsum), t(bsq), got, summary_decay_rate=0.5)
            ref = ref_ops.data_norm_update_summary(
                jnp.asarray(bsize), jnp.asarray(bsum), jnp.asarray(bsq),
                want, summary_decay_rate=0.5)
            for g, w in zip(upd, ref):
                close(g, w)

    @pytest.mark.parametrize("ranks,pvo", [
        ([1, 2, 3, 1, 2, 0], [0, 3, 6]),
        # own rank 5 > max_rank: the reference's gather clamps the block
        # index (12 for 9 blocks) to the last block
        ([1, 2, 5, 3], [0, 4]),
    ])
    def test_rank_attention(self, ranks, pvo):
        x, ro, param = rank_inputs(ranks, pvo, len(ranks))
        got = ops.rank_attention(t(x), t(ro), t(param), 3)
        want = ref_ops.rank_attention(jnp.asarray(x), jnp.asarray(ro),
                                      jnp.asarray(param), 3)
        close(got, want)
        for i, r in enumerate(ranks):
            if r == 0:
                assert (got[i] == 0).all()       # an invalid row: zero
            if r > 3:
                assert got[i].abs().sum() > 0    # the clamped block
        np.testing.assert_array_equal(
            ops.build_rank_offset(np.array(ranks), np.array(pvo), 3), ro)

    def test_batch_fc_scaled_fc_cross_norm(self):
        rng = np.random.default_rng(4)
        x = rng.normal(size=(6, 3 * 4)).astype(np.float32)
        w = rng.normal(size=(4, 3 * 5)).astype(np.float32)
        b = rng.normal(size=15).astype(np.float32)
        close(ops.batch_fc(t(x), t(w), t(b), 3),
              ref_ops.batch_fc(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), 3))
        xs = rng.normal(size=(8, 16)).astype(np.float32)
        ws = rng.normal(size=(16, 6)).astype(np.float32)
        bs = rng.normal(size=6).astype(np.float32)
        got = ops.scaled_fc(t(xs), t(ws), t(bs), 0.5, 2.0)
        assert got.dtype == torch.float32
        close(got, ref_ops.scaled_fc(jnp.asarray(xs), jnp.asarray(ws),
                                     jnp.asarray(bs), 0.5, 2.0), tol=0.05)
        xc = rng.normal(size=(5, 2 * 3 * 4)).astype(np.float32)
        mean = rng.normal(size=3 * 13).astype(np.float32)
        scale = rng.random(3 * 13).astype(np.float32) + 0.5
        close(ops.cross_norm_raw(t(xc), 3, 4),
              ref_ops.cross_norm_raw(jnp.asarray(xc), 3, 4))
        close(ops.cross_norm_hadamard(t(xc), t(mean), t(scale), 3, 4),
              ref_ops.cross_norm_hadamard(jnp.asarray(xc),
                                          jnp.asarray(mean),
                                          jnp.asarray(scale), 3, 4))


def torch_grad(fn, *arrays):
    ts = [t(a).clone().requires_grad_(True) for a in arrays]
    fn(*ts).square().sum().backward()
    return [x.grad if x.grad is not None else torch.zeros_like(x)
            for x in ts]


def jax_grad(fn, *arrays):
    return jax.grad(lambda *a: jnp.square(fn(*a)).sum(),
                    argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))


class TestGradients:
    def test_data_norm_batch_fc_cross_norm(self):
        rng = np.random.default_rng(5)
        x = rng.normal(size=(4, 3)).astype(np.float32)
        sw, bias = rng.normal(size=(2, 3)).astype(np.float32)
        summ = (np.full(3, 10.0, np.float32), np.ones(3, np.float32),
                np.full(3, 40.0, np.float32))
        for g, w in zip(
                torch_grad(lambda a, s, b: ops.data_norm(
                    a, *map(t, summ), s, b), x, sw, bias),
                jax_grad(lambda a, s, b: ref_ops.data_norm(
                    a, *map(jnp.asarray, summ), s, b), x, sw, bias)):
            close(g, w)
        xb = rng.normal(size=(6, 8)).astype(np.float32)
        wb = rng.normal(size=(4, 6)).astype(np.float32)
        bb = rng.normal(size=6).astype(np.float32)
        for g, w in zip(
                torch_grad(lambda a, b, c: ops.batch_fc(a, b, c, 2),
                           xb, wb, bb),
                jax_grad(lambda a, b, c: ref_ops.batch_fc(a, b, c, 2),
                         xb, wb, bb)):
            close(g, w)
        xc = rng.normal(size=(5, 2 * 2 * 3)).astype(np.float32)
        mean = rng.normal(size=2 * 10).astype(np.float32)
        scale = rng.random(2 * 10).astype(np.float32) + 0.5
        for g, w in zip(
                torch_grad(lambda a, m, s: ops.cross_norm_hadamard(
                    a, m, s, 2, 3), xc, mean, scale),
                jax_grad(lambda a, m, s: ref_ops.cross_norm_hadamard(
                    a, m, s, 2, 3), xc, mean, scale)):
            close(g, w)

    def test_rank_attention_param_only(self):
        x, ro, param = rank_inputs([1, 2, 5, 3, 1, 0], [0, 4, 6], 6)
        gx, gp = torch_grad(
            lambda a, p: ops.rank_attention(a, t(ro), p, 3), x, param)
        wx, wp = jax_grad(
            lambda a, p: ref_ops.rank_attention(a, jnp.asarray(ro), p, 3),
            x, param)
        close(gp, wp)
        assert float(np.abs(np.asarray(wx)).max()) == 0.0
        assert float(gx.abs().max()) == 0.0


# -- page-view batching -------------------------------------------------------

def feed_confs():
    jconf = JaxFeedConfig(slots=[
        JaxSlotConfig("label", type="float", is_dense=True, dim=1),
        JaxSlotConfig("slot_a"), JaxSlotConfig("slot_b"),
        JaxSlotConfig("slot_c")], batch_size=8, label_slot="label")
    return jconf, DataFeedConfig.from_dict(dataclasses.asdict(jconf))


@pytest.fixture(scope="module")
def pv_records(tmp_path_factory):
    """The same 30 parsed records in each package, tagged with PV ids of
    1-5 ads and 1-based ranks (a few above max_rank, a few unknown)."""
    jconf, pconf = feed_confs()
    path = make_slot_file(str(tmp_path_factory.mktemp("pv") / "part"),
                          jconf, 30, seed=7)
    lines = open(path).read().splitlines()
    jp, pp = JaxSlotParser(jconf), SlotParser(pconf)
    jrecs = [jp.parse_line(ln) for ln in lines]
    precs = [pp.parse_line(ln) for ln in lines]
    rng = np.random.default_rng(8)
    sid, rank = 100, 0
    left = 0
    for jr, pr in zip(jrecs, precs):
        if left == 0:
            sid, rank, left = sid + int(rng.integers(1, 9)), 0, \
                int(rng.integers(1, 6))
        rank += 1
        r = 0 if rng.random() < 0.1 else rank
        jr.search_id = pr.search_id = sid
        jr.rank = pr.rank = r
        left -= 1
    return jconf, pconf, jrecs, precs


def test_pv_batches_match_reference(pv_records):
    jconf, pconf, jrecs, precs = pv_records
    assert [[r.search_id for r in g] for g in pv.group_by_pv(precs)] == \
        [[r.search_id for r in g] for g in ref_pv.group_by_pv(jrecs)]
    got = list(pv.PvBatchAssembler(pconf, 2).batches(precs))
    want = list(ref_pv.PvBatchAssembler(jconf, 2).batches(jrecs))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.pv_num == w.pv_num
        np.testing.assert_array_equal(g.pv_offsets, w.pv_offsets)
        np.testing.assert_array_equal(g.rank_offset, w.rank_offset)
        assert g.rank_offset.dtype == np.int32
        assert g.batch.rank_offset is g.rank_offset
        np.testing.assert_array_equal(g.batch.rank_offset,
                                      w.batch.rank_offset)
        for f in ("keys", "segment_ids", "lengths", "labels", "dense"):
            np.testing.assert_array_equal(getattr(g.batch, f),
                                          getattr(w.batch, f))
        assert (g.batch.num_rows, g.batch.num_keys) == \
            (w.batch.num_rows, w.batch.num_keys)
    assert len(list(pv.PvBatchAssembler(pconf, 2).batches(
        precs, drop_remainder=True))) == len(list(
            ref_pv.PvBatchAssembler(jconf, 2).batches(
                jrecs, drop_remainder=True)))


def test_pv_chunk_larger_than_batch_raises(pv_records):
    jconf, pconf, jrecs, precs = pv_records
    with pytest.raises(ValueError) as want:
        list(ref_pv.PvBatchAssembler(jconf, 4).batches(jrecs))
    with pytest.raises(ValueError) as got:
        list(pv.PvBatchAssembler(pconf, 4).batches(precs))
    assert str(got.value) == str(want.value)
    assert "raise batch_size or lower pv_batch_size" in str(got.value)
