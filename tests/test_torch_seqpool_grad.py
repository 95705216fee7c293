"""Port's seqpool+CVM backward (the straight-through gather, plain PyTorch
on the CPU) vs ``jax.vjp`` of the JAX op and of the Pallas kernel in
interpret mode, on the same numpy inputs.

Tolerance atol=0: the backward copies values and does no arithmetic."""

import jax
import numpy as np
import pytest
import torch

from paddlebox_tpu.ops.pallas_seqpool import pallas_seqpool_cvm
from paddlebox_tpu.ops.seqpool_cvm import fused_seqpool_cvm as jax_fused
from paddlebox_tpu_torch.ops import seqpool_kernel
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm


def make_inputs(seed, B, S, D, npad, cvm_width, lengths=None):
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = rng.integers(0, 4, size=B * S)
    n = min(int(lengths.sum()), npad)
    segs = np.full(npad, B * S, dtype=np.int32)
    segs[:n] = np.repeat(np.arange(B * S, dtype=np.int32), lengths)[:n]
    emb = rng.normal(size=(npad, D)).astype(np.float32) * 0.3
    emb[:, 0] = rng.integers(1, 30, size=npad)
    emb[:, 1] = rng.integers(0, 2, size=npad)
    cvm = rng.normal(size=(B, cvm_width)).astype(np.float32)
    return rng, emb, segs, cvm


def port_grad(emb, segs, cvm, g, *args, **kw):
    e = torch.from_numpy(emb).requires_grad_(True)
    out = fused_seqpool_cvm(e, torch.from_numpy(segs), torch.from_numpy(cvm),
                            *args, **kw)
    out.backward(torch.from_numpy(g))
    return e.grad.numpy()


def jax_grad(fn, emb, segs, cvm, g, *args, **kw):
    _, vjp = jax.vjp(lambda e: fn(e, segs, cvm, *args, **kw), emb)
    return np.asarray(vjp(g)[0])


SHAPES = [(8, 4, 11, 1024), (32, 5, 16, 2048), (16, 26, 11, 512)]


@pytest.mark.parametrize("use_cvm,cvm_offset", [(True, 2), (True, 3),
                                                (False, 2), (False, 3)])
@pytest.mark.parametrize("B,S,D,npad", SHAPES)
def test_matches_jax_vjp_and_pallas(B, S, D, npad, use_cvm, cvm_offset):
    """Random lengths 0-3: empty segments, padding keys, and (at npad=512)
    a key array cut short with no padding key."""
    rng, emb, segs, cvm = make_inputs(0, B, S, D, npad, cvm_offset)
    width = D if use_cvm else D - cvm_offset
    g = rng.normal(size=(B, S, width)).astype(np.float32)
    args = (B, S, use_cvm, cvm_offset)
    got = port_grad(emb, segs, cvm, g, *args)
    np.testing.assert_array_equal(
        got, jax_grad(jax_fused, emb, segs, cvm, g, *args))
    np.testing.assert_array_equal(
        got, jax_grad(pallas_seqpool_cvm, emb, segs, cvm, g, *args,
                      interpret=True))


@pytest.mark.parametrize("quant_ratio", [0, 128])
@pytest.mark.parametrize("embed_threshold", [0.0, 0.5])
def test_filter_and_quant_leave_the_backward_alone(embed_threshold,
                                                   quant_ratio):
    """need_filter / embed_threshold / quant_ratio change the forward only
    (the reference's grad kernels ignore them)."""
    B, S, D = 8, 4, 11
    rng, emb, segs, cvm = make_inputs(1, B, S, D, 1024, 2)
    g = rng.normal(size=(B, S, D)).astype(np.float32)
    kw = dict(need_filter=True, threshold=2.0,
              embed_threshold=embed_threshold, quant_ratio=quant_ratio)
    got = port_grad(emb, segs, cvm, g, B, S, True, 2, **kw)
    np.testing.assert_array_equal(
        got, jax_grad(jax_fused, emb, segs, cvm, g, B, S, True, 2, 0.0,
                      **kw))
    np.testing.assert_array_equal(
        got, port_grad(emb, segs, cvm, g, B, S, True, 2))


def test_plain_backward_matches_jax_bwd_directly():
    """``seqpool_cvm_grad`` (the wrapper the autograd Function calls) on
    the CPU against the reference's ``_bwd`` itself, all keys padding."""
    from paddlebox_tpu.ops.seqpool_cvm import _bwd
    B, S, D = 4, 3, 11
    rng, emb, segs, cvm = make_inputs(2, B, S, D, 64, 2,
                                      lengths=np.zeros(12, np.int64))
    g = rng.normal(size=(B, S, D)).astype(np.float32)
    got = seqpool_kernel.seqpool_cvm_grad(
        torch.from_numpy(g), torch.from_numpy(segs), torch.from_numpy(cvm),
        B, S, True, 2).numpy()
    want = np.asarray(_bwd(B, S, True, 2, 0.0, False, 0.2, 1.0, 0.96, 0.0,
                           0, (segs, cvm, emb.shape), g)[0])
    np.testing.assert_array_equal(got, want)
    assert not got.any()


def test_show_clk_grads_carry_cvm_in_not_the_log_derivative():
    """Hazard (a): autograd through the forward would give the CVM log
    columns' derivative; only the custom backward carries cvm_in."""
    B, S, D = 8, 4, 11
    rng, emb, segs, cvm = make_inputs(3, B, S, D, 1024, 2)
    g = rng.normal(size=(B, S, D)).astype(np.float32)
    got = port_grad(emb, segs, cvm, g, B, S, True, 2)
    e = torch.from_numpy(emb).requires_grad_(True)
    seqpool_kernel.seqpool_cvm_plain(e, torch.from_numpy(segs), B, S).backward(
        torch.from_numpy(g))
    naive = e.grad.numpy()
    real = segs < B * S
    np.testing.assert_array_equal(got[real, :2], cvm[segs[real] // S])
    assert not np.allclose(naive[real, :2], got[real, :2])
    np.testing.assert_array_equal(got[real, 2:], naive[real, 2:])


def test_table_cvm_offset_3_with_seqpool_cvm_offset_2():
    """Hazard (b): the flagship table has cvm_offset=3 but the seqpool's is
    2, so cvm_in is [B, 2] and column 2 (embed_w) takes the pooled grad."""
    B, S, D = 8, 4, 11
    rng, emb, segs, cvm = make_inputs(4, B, S, D, 1024, 2)
    g = rng.normal(size=(B, S, D)).astype(np.float32)
    got = port_grad(emb, segs, cvm, g, B, S, True, 2)
    real = segs < B * S
    np.testing.assert_array_equal(got[real, 2],
                                  g.reshape(B * S, D)[segs[real], 2])
    assert (got[~real] == 0).all()


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        seqpool_kernel.seqpool_cvm_grad_cuda(
            torch.zeros(1, 2, 11), torch.zeros(4, dtype=torch.int32),
            torch.zeros(1, 2), 1, 2)
    assert seqpool_kernel.seqpool_cvm_grad_cuda.launches == 0


def layout_lengths(kind, B, S):
    """Segment lengths of layouts away from the training batch's."""
    n_seg = B * S
    lengths = np.zeros(n_seg, np.int64)
    if kind == "empty-runs":
        # long runs of empty segments between a few full ones
        lengths[::37] = 3
        lengths[5] = 40
    elif kind == "first-and-last":
        lengths[0] = 50
        lengths[-1] = 70
    return lengths


@pytest.mark.parametrize("use_cvm,cvm_offset", [(True, 2), (False, 3)])
@pytest.mark.parametrize("kind", ["unsorted", "empty-runs",
                                  "first-and-last"])
def test_plain_backward_matches_jax_vjp_on_other_layouts(kind, use_cvm,
                                                         cvm_offset):
    """Layouts the card's checks also run: unsorted ids (a permutation,
    padding keys among them), long runs of empty segments, and every key
    in the first and the last segment. The JAX op takes ids in any order;
    atol 0."""
    B, S, D, npad = 16, 6, 11, 512
    lengths = None if kind == "unsorted" else layout_lengths(kind, B, S)
    rng, emb, segs, cvm = make_inputs(5, B, S, D, npad, cvm_offset,
                                      lengths=lengths)
    if kind == "unsorted":
        perm = rng.permutation(npad)
        segs, emb = segs[perm], emb[perm]
    width = D if use_cvm else D - cvm_offset
    g = rng.normal(size=(B, S, width)).astype(np.float32)
    args = (B, S, use_cvm, cvm_offset)
    got = port_grad(emb, segs, cvm, g, *args)
    np.testing.assert_array_equal(
        got, jax_grad(jax_fused, emb, segs, cvm, g, *args))
    real = segs < B * S
    assert real.any() and (~real).any()
    assert not got[~real].any()


@pytest.mark.parametrize("dim,lanes", [
    (1, 1), (11, 1), (16, 1),     # the flagship's D=11: a thread a key
    (17, 2), (24, 2), (32, 2),
    (33, 4), (50, 4), (64, 4),
    (65, 8), (200, 8), (256, 8),  # at most 8: a warp keeps 4 keys
])
def test_grad_lanes_values(dim, lanes):
    assert seqpool_kernel.grad_lanes(dim) == lanes


def test_grad_lanes_chunks_fit_every_width():
    """Every row width the kernel takes: a power of two of at most 8
    lanes, at most 16 columns a lane below 8 lanes, a warp's chunk of a
    multiple of 4 keys, and a block's 4 chunks within 16 KB of shared
    memory."""
    for dim in range(1, seqpool_kernel.MAX_DIM + 1):
        lanes = seqpool_kernel.grad_lanes(dim)
        assert lanes in (1, 2, 4, 8)
        assert lanes == 8 or -(-dim // lanes) <= 16
        keys = 32 // lanes
        assert keys % 4 == 0
        assert 4 * keys * dim * 4 <= 16 * 1024


def test_dispatch_refuses_devices_other_than_cpu_and_cuda():
    """``seqpool_cvm_grad`` takes the kernel for CUDA tensors and the plain
    version for CPU ones; any other device raises, and nothing launches."""
    with pytest.raises(ValueError, match="unsupported device"):
        seqpool_kernel.seqpool_cvm_grad(
            torch.zeros(1, 2, 11, device="meta"),
            torch.zeros(4, dtype=torch.int32, device="meta"),
            torch.zeros(1, 2, device="meta"), 1, 2)
    assert seqpool_kernel.seqpool_cvm_grad_cuda.launches == 0
