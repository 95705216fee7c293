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
