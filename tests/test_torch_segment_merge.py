"""The mesh step's requester merge past a chunk (``ops/sparse_push.py``
``segment_merge_plain``, ``SEGMENT_CHUNK``): its fixed two-level order
against a numpy sum in the same order and against ``np.add.at``; device
prep's merge by unique against the merge by request position with a key
repeated past a chunk; the 2-shard mesh with such a hot key against the
reference's (``paddlebox_tpu/parallel/fused_dp_step.py``); the kernel's
wrapper refusing CPU tensors; the chunk shared by the kernel's source and
the plain version.

Tolerances: the plain version against the numpy two-level sum and the two
merges against each other, bit for bit. Against ``np.add.at`` (key order,
one chain) a segment of L keys may differ by re-association alone: each
order's float32 sum is within (L - 1) u sum|x| of the exact one (u =
2^-24), so the two within 2 (L - 1) u sum|x|, element by element. The
mesh against the reference: per-step loss rtol 1e-5, rows by key show/clk
exact, the rest atol 1e-5, as in ``test_torch_fused_sharded.py``, and the
optimizer state atol 1e-5 but on the hot keys' rows, each value there
within the larger of 1e-5 and 1e-5 of its size: the hot key's adagrad
g2sum reaches ~4.2, where float32 sums in another order (the
reference's one chain against the chunks; the reference's psum, its
dense grads) differ by up to ~1.3e-5, 28 ulps (key order alone: 6.2e-6)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu_torch.config import TableConfig, TrainerConfig
from paddlebox_tpu_torch.models import DeepFM
from paddlebox_tpu_torch.ops.sparse_push import (SEGMENT_CHUNK,
                                                 merge_order, merge_segments,
                                                 segment_merge,
                                                 segment_merge_cuda,
                                                 segment_merge_plain)
from paddlebox_tpu_torch.parallel.fused_dp_step import FusedShardedTrainStep
from paddlebox_tpu_torch.parallel.mesh import make_mesh
from paddlebox_tpu_torch.ps import native
from paddlebox_tpu_torch.ps.sharded_device_table import ShardedDeviceTable
from torch_mesh_worlds import (TABLE, make_batch, rows_by_key, step_both,
                               worlds)

C = SEGMENT_CHUNK
U = 2.0 ** -24
SOURCE = (Path(__file__).resolve().parents[1] / "paddlebox_tpu_torch" /
          "csrc" / "sparse_push.cu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def two_level(demb: np.ndarray, order: np.ndarray,
              offsets: np.ndarray) -> np.ndarray:
    """The merge's order in numpy float32: a segment of at most C keys from
    0 in key order; a longer one each chunk of C so, then from 0 the
    chunks' sums in chunk order."""
    out = np.zeros((offsets.size - 1, demb.shape[1]), np.float32)
    for s in range(offsets.size - 1):
        lo, hi = int(offsets[s]), int(offsets[s + 1])
        partials = []
        for c0 in range(lo, max(hi, lo + 1), C):
            acc = np.zeros(demb.shape[1], np.float32)
            for k in order[c0:min(c0 + C, hi)]:
                acc = acc + demb[k]
            partials.append(acc)
        if len(partials) == 1:
            out[s] = partials[0]
        else:
            acc = np.zeros(demb.shape[1], np.float32)
            for p in partials:
                acc = acc + p
            out[s] = acc
    return out


@pytest.mark.parametrize("dim", [1, 11, 64, 256])
@pytest.mark.parametrize("length", [C - 1, C, C + 1, 2 * C + 1, 17612])
def test_plain_sums_in_chunks(length, dim):
    """Segments of ``length`` keys (a chunk's edges, the Zipf mix's hot
    key) among short and empty ones, keys in random order, grads of mixed
    sign and scale: the plain version is the numpy two-level sum bit for
    bit, and ``np.add.at``'s within re-association."""
    rng = np.random.default_rng(length * 1000 + dim)
    lengths = [3, 0, length, 1, 0, 40]
    n_seg = len(lengths)
    seg = np.repeat(np.arange(n_seg, dtype=np.int32), lengths)
    seg = seg[rng.permutation(seg.size)]
    demb = (rng.normal(size=(seg.size, dim)) *
            10.0 ** rng.integers(-3, 3, size=(seg.size, 1))).astype(
                np.float32)
    order, offsets = merge_order(torch.from_numpy(seg), n_seg)
    got = segment_merge_plain(torch.from_numpy(demb), order, offsets).numpy()
    np.testing.assert_array_equal(
        got, two_level(demb, order.numpy(), offsets.numpy()))
    np.testing.assert_array_equal(
        segment_merge(torch.from_numpy(demb), torch.from_numpy(seg),
                      n_seg).numpy(), got)
    key_order = np.zeros((n_seg, dim), np.float32)
    np.add.at(key_order, seg, demb)
    abs_sum = np.zeros((n_seg, dim), np.float64)
    np.add.at(abs_sum, seg, np.abs(demb).astype(np.float64))
    bound = 2 * (np.asarray(lengths)[:, None] - 1).clip(0) * U * abs_sum
    assert (np.abs(got.astype(np.float64) - key_order) <= bound).all()
    # at most C keys: the one chain of key order, so np.add.at's bits
    short = np.asarray(lengths) <= C
    np.testing.assert_array_equal(got[short], key_order[short])


@pytest.mark.parametrize("ndev", [1, 2])
def test_device_prep_merge_matches_position_merge_past_a_chunk(ndev):
    """Device prep's requester merge by unique over K5's order equals the
    merge by request position bit for bit when one key repeats C + 100
    times in a batch of 2,048 keys: its unique's segment and its request
    position's hold the same keys in the same order, so the same chunks."""
    rng = np.random.default_rng(ndev)
    table = ShardedDeviceTable(TableConfig(**TABLE),
                               make_mesh(ndev, device="cpu"),
                               capacity_per_shard=64)
    step = FusedShardedTrainStep(DeepFM(3 * 7 + 3, (8,)), table,
                                 TrainerConfig(), batch_size=8, num_slots=3,
                                 device_prep=True)
    npad, n, R = 2048, 2000, 1024
    keys = np.zeros(npad, np.uint64)
    keys[:n] = rng.integers(1, 1 << 62, size=n).astype(np.uint64)
    keys[rng.permutation(n)[:C + 100]] = keys[0]
    _, seg, n_over, dd, flat = step._route(
        torch.from_numpy(keys.view(np.int64)), R)
    assert int(n_over) == 0
    demb = torch.from_numpy(rng.normal(size=(npad, 7)).astype(np.float32))
    got = step._merge_routed(demb, dd, flat, R)
    want = step._merge_requests(demb, seg, R)
    assert torch.equal(got, want)
    order, offsets = step._unique_merge_order(dd)
    assert int((offsets[1:] - offsets[:-1]).max()) == \
        int((keys == keys[0]).sum()) > C
    # and the chunks summed, not the chain of key order
    M = ndev * R
    merged = merge_segments(demb, order, offsets)
    hot = int(torch.argmax(offsets[1:] - offsets[:-1]))
    pos = int(flat[hot])
    assert torch.equal(got.reshape(M, -1)[pos], merged[hot])


@pytest.mark.parametrize("engine", ["host_plan", "device_prep"])
def test_mesh_hot_key_past_a_chunk_matches_reference(engine):
    """Two shards, 3 steps whose first shard's batch repeats one key C +
    200 times (its grads merged by chunks on the requester): losses and
    rows by key against the reference's."""
    if not (native.available() and ref_native.available()):
        pytest.skip("the native index core does not build here")
    dp = engine == "device_prep"
    B, S, npad = 8, 4, 2560
    ref, port = worlds(2, dp, B, S, table_kw=dict(initial_range=0.05))
    rng = np.random.default_rng(11)
    hot_keys = []
    for step in range(3):
        args = make_batch(rng, 2, B, S, npad, 5000)
        keys = args[0]
        real = np.flatnonzero(keys[0])
        keys[0, rng.permutation(real)[:C + 200]] = keys[0, real[0]]
        hot_keys.append(keys[0, real[0]])
        jl, pl = step_both(ref, port, args, dp)
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
    jt, pt = ref[1], port[1]
    assert list(jt._sizes) == list(pt._sizes)
    jk, jv, js = rows_by_key(jt.snapshot())
    pk, pv, pst = rows_by_key(pt.snapshot())
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pv[:, :2], jv[:, :2])
    np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-5)
    # the optimizer state at atol 1e-5, but for the hot keys' rows: their
    # g2sum grows to ~4, summed by chunks, so within the larger of 1e-5
    # and 1e-5 of its size
    hot = np.isin(pk, hot_keys)
    assert hot.sum() == len(set(hot_keys))
    np.testing.assert_allclose(pst[~hot], js[~hot], rtol=0, atol=1e-5)
    diff = np.abs(pst[hot] - js[hot])
    assert (diff <= np.maximum(1e-5, 1e-5 * np.abs(js[hot]))).all(), diff


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper raises on CPU tensors; ``merge_segments`` takes
    the plain version for them."""
    demb = torch.ones((3, 2))
    order = torch.arange(3)
    offsets = torch.tensor([0, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        segment_merge_cuda(demb, order, offsets)
    assert segment_merge_cuda.launches == 0
    assert torch.equal(merge_segments(demb, order, offsets),
                       torch.full((1, 2), 3.0))


def test_chunk_is_the_kernels():
    """``SEGMENT_CHUNK`` is the kernel's ``kChunk``, and at least 1024 (so
    a segment of up to 1024 keys sums in key order on both)."""
    m = re.search(r"constexpr int kChunk = (\d+);", SOURCE.read_text())
    assert m and int(m.group(1)) == C >= 1024
