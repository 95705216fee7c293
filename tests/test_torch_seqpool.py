"""Port's seqpool+CVM (plain PyTorch, on the CPU) vs the JAX op and the
Pallas kernel in interpret mode, on the same numpy inputs.

Tolerance rtol=atol=1e-6: both sides sum the same float32 values per
segment; only the summation order may differ."""

import numpy as np
import pytest
import torch

from paddlebox_tpu.ops.pallas_seqpool import pallas_seqpool_cvm
from paddlebox_tpu.ops.seqpool_cvm import fused_seqpool_cvm as jax_fused
from paddlebox_tpu_torch.ops import seqpool_kernel
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm

TOL = dict(rtol=1e-6, atol=1e-6)


def make_inputs(seed, B, S, D, npad, cvm_width=2):
    """tests/test_pallas_seqpool.py's inputs, with a cvm_in of any width."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 4, size=B * S)
    n = min(int(lengths.sum()), npad)
    segs = np.full(npad, B * S, dtype=np.int32)
    segs[:n] = np.repeat(np.arange(B * S, dtype=np.int32), lengths)[:n]
    emb = rng.normal(size=(npad, D)).astype(np.float32) * 0.3
    emb[:, 0] = rng.integers(1, 30, size=npad)  # shows
    emb[:, 1] = rng.integers(0, 2, size=npad)
    emb[n:] = 0.0
    cvm = rng.normal(size=(B, cvm_width)).astype(np.float32)
    return emb, segs, cvm


def port(emb, segs, cvm, *args, **kw):
    return fused_seqpool_cvm(torch.from_numpy(emb), torch.from_numpy(segs),
                             torch.from_numpy(cvm), *args, **kw).numpy()


SHAPES = [(8, 4, 11, 1024), (32, 5, 16, 2048), (16, 26, 11, 1024)]


@pytest.mark.parametrize("pad_value", [0.0, 0.5])
@pytest.mark.parametrize("use_cvm,cvm_offset", [(True, 2), (True, 3),
                                                (False, 2), (False, 3)])
@pytest.mark.parametrize("B,S,D,npad", SHAPES)
def test_matches_jax_and_pallas(B, S, D, npad, use_cvm, cvm_offset,
                                pad_value):
    emb, segs, cvm = make_inputs(0, B, S, D, npad, cvm_offset)
    got = port(emb, segs, cvm, B, S, use_cvm, cvm_offset, pad_value)
    want = np.asarray(jax_fused(emb, segs, cvm, B, S, use_cvm, cvm_offset,
                                pad_value))
    np.testing.assert_allclose(got, want, **TOL)
    pallas = np.asarray(pallas_seqpool_cvm(emb, segs, cvm, B, S, use_cvm,
                                           cvm_offset, pad_value,
                                           interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)


def tile_edge_lengths(kind, B, S, rng):
    """Segment lengths aimed at the CUDA kernel's tiles of 128 keys."""
    lengths = rng.integers(0, 3, size=B * S)
    if kind == "segment-of-300-keys":
        lengths[5] = 300
    elif kind == "all-keys-in-last-segment":
        lengths[:] = 0
        lengths[-1] = 300
    elif kind == "boundary-at-key-128":
        lengths[:4] = [100, 28, 64, 64]    # boundaries at keys 128 and 256
    return lengths


@pytest.mark.parametrize("use_cvm,cvm_offset,pad_value",
                         [(True, 2, 0.0), (False, 3, 0.5)])
@pytest.mark.parametrize("kind", ["segment-of-300-keys", "no-padding-key",
                                  "all-keys-in-last-segment",
                                  "boundary-at-key-128"])
def test_tile_edge_shapes_match_jax_and_pallas(kind, use_cvm, cvm_offset,
                                               pad_value):
    """Embeddings on a 2^-11 grid and at most 3 in size: sums of up to 300
    keys are exact in any order, so the sides agree to the tolerance."""
    B, S, D = 8, 4, 11
    rng = np.random.default_rng(7)
    lengths = tile_edge_lengths(kind, B, S, rng)
    n = int(lengths.sum())
    npad = n if kind == "no-padding-key" else n + 61
    segs = np.full(npad, B * S, dtype=np.int32)
    segs[:n] = np.repeat(np.arange(B * S, dtype=np.int32), lengths)
    assert kind != "no-padding-key" or (segs < B * S).all()
    emb = np.round(rng.normal(size=(npad, D)) * 1024) / 2048
    emb = np.clip(emb, -3, 3).astype(np.float32)
    emb[:, 0] = rng.integers(1, 30, size=npad)
    emb[:, 1] = rng.integers(0, 2, size=npad)
    cvm = rng.normal(size=(B, cvm_offset)).astype(np.float32)
    got = port(emb, segs, cvm, B, S, use_cvm, cvm_offset, pad_value)
    want = np.asarray(jax_fused(emb, segs, cvm, B, S, use_cvm, cvm_offset,
                                pad_value))
    np.testing.assert_allclose(got, want, **TOL)
    pallas = np.asarray(pallas_seqpool_cvm(emb, segs, cvm, B, S, use_cvm,
                                           cvm_offset, pad_value,
                                           interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)


def test_bulk_loads_needs_both_pointers_16_byte_aligned():
    emb = torch.zeros((65, 11))
    segs = torch.zeros(65, dtype=torch.int32)
    assert emb.data_ptr() % 16 == 0 and segs.data_ptr() % 16 == 0
    assert seqpool_kernel.bulk_loads(emb, segs)
    # one row in: 44 bytes past an aligned allocation
    assert not seqpool_kernel.bulk_loads(emb[1:], segs[1:])
    assert not seqpool_kernel.bulk_loads(emb[1:], segs[:-1])
    # four rows of 11 floats (176 bytes) and four ids land on 16 again
    assert seqpool_kernel.bulk_loads(emb[4:], segs[4:])


@pytest.mark.parametrize("variant", [
    dict(need_filter=True),
    dict(need_filter=True, threshold=5.0, show_coeff=0.5),
    dict(need_filter=True, embed_threshold=0.4),
    dict(quant_ratio=128),
    dict(need_filter=True, embed_threshold=0.3, quant_ratio=64,
         pad_value=0.25),
])
@pytest.mark.parametrize("use_cvm", [True, False])
def test_filter_and_quant_variants_match_jax(variant, use_cvm):
    B, S, D, npad = 16, 26, 11, 1024
    emb, segs, cvm = make_inputs(3, B, S, D, npad, 3)
    kw = dict(use_cvm=use_cvm, cvm_offset=3, **variant)
    got = port(emb, segs, cvm, B, S, **kw)
    want = np.asarray(jax_fused(emb, segs, cvm, B, S, **kw))
    np.testing.assert_allclose(got, want, **TOL)


def test_all_padding_batch_matches_jax():
    B, S, D = 4, 26, 11
    emb = np.random.default_rng(1).normal(size=(1024, D)).astype(np.float32)
    segs = np.full(1024, B * S, dtype=np.int32)
    cvm = np.ones((B, 2), np.float32)
    got = port(emb, segs, cvm, B, S, True, 2, 0.5)
    want = np.asarray(jax_fused(emb, segs, cvm, B, S, True, 2, 0.5))
    np.testing.assert_allclose(got, want, **TOL)


def test_cvm_in_width_must_equal_cvm_offset():
    emb, segs, cvm = make_inputs(0, 4, 2, 11, 256, 2)
    with pytest.raises(ValueError, match="cvm_offset"):
        port(emb, segs, cvm, 4, 2, True, 3)


def test_cpu_tensor_takes_plain_version_without_launching():
    emb, segs, _ = make_inputs(2, 8, 4, 11, 1024)
    e, s = torch.from_numpy(emb), torch.from_numpy(segs)
    before = seqpool_kernel.seqpool_cvm_cuda.launches
    got = seqpool_kernel.seqpool_cvm(e, s, 8, 4)
    want = seqpool_kernel.seqpool_cvm_plain(e, s, 8, 4)
    assert torch.equal(got, want)
    assert seqpool_kernel.seqpool_cvm_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    emb, segs, _ = make_inputs(2, 8, 4, 11, 1024)
    with pytest.raises(ValueError, match="CUDA"):
        seqpool_kernel.seqpool_cvm_cuda(torch.from_numpy(emb),
                                        torch.from_numpy(segs), 8, 4)


def test_plain_version_accepts_unsorted_ids():
    emb, segs, _ = make_inputs(4, 8, 4, 11, 1024)
    perm = np.random.default_rng(5).permutation(segs.size)
    a = seqpool_kernel.seqpool_cvm_plain(torch.from_numpy(emb),
                                         torch.from_numpy(segs), 8, 4)
    b = seqpool_kernel.seqpool_cvm_plain(torch.from_numpy(emb[perm]),
                                         torch.from_numpy(segs[perm]), 8, 4)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
