"""Port's seqpool variants ``fused_seqpool_cvm_with_conv`` and
``fused_seqpool_cvm_with_pcoc`` (``ops/seqpool_cvm.py``) and the un-fused
``cvm`` (``ops/cvm.py``) against the JAX package's, on the CPU: the same
seeded inputs, the forward and the straight-through grads of a random
cotangent (``jax.vjp`` against ``torch.autograd``), and the same width
errors. Tolerances: forward and grads within 1e-6 (sums in another
order, logs of them); the grads' head columns (the instance's show/clk,
conv, q values: copies, not arithmetic) exact, and the grads of
``cvm_in`` and ``q_values`` exactly zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.ops import cvm as ref_cvm
from paddlebox_tpu.ops import seqpool_cvm as ref_seqpool
from paddlebox_tpu_torch import ops

B, S, NPAD = 6, 3, 64
TOL = dict(rtol=1e-6, atol=1e-6)


def batch(width, seed, heads):
    """Keys of B*S (row, slot)s (1-4 each, some padding at the end, some
    slots empty), rows whose first ``heads`` columns are counts."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 4, size=B * S)
    n = int(lengths.sum())
    assert n < NPAD
    segs = np.full(NPAD, B * S, np.int32)
    segs[:n] = np.repeat(np.arange(B * S, dtype=np.int32), lengths)
    emb = rng.normal(size=(NPAD, width)).astype(np.float32)
    emb[:, :heads] = rng.integers(0, 9, size=(NPAD, heads))
    return emb, segs


def torch_run(fn, arrays, g, grad_of):
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    for i in grad_of:
        ts[i].requires_grad_(True)
    out = fn(*ts)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [ts[i].grad.numpy() for i in grad_of]


def jax_run(fn, arrays, g, grad_of):
    def f(*diff):
        args = list(arrays)
        for i, d in zip(grad_of, diff):
            args[i] = d
        return fn(*args)
    out, vjp = jax.vjp(f, *[jnp.asarray(arrays[i]) for i in grad_of])
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("use_cvm,show_filter,pad_value", [
    (True, False, 0.0), (True, True, 0.5), (False, False, 0.0)])
def test_with_conv_matches_reference(use_cvm, show_filter, pad_value):
    E = 5
    emb, segs = batch(3 + E, 1, 3)
    cvm_in = np.random.default_rng(2).integers(
        0, 3, size=(B, 3)).astype(np.float32)
    kw = dict(use_cvm=use_cvm, show_filter=show_filter, pad_value=pad_value)
    width = E if not use_cvm else (2 + E if show_filter else 3 + E)
    g = np.random.default_rng(3).normal(size=(B, S, width)).astype(
        np.float32)
    got, (gemb, gcvm) = torch_run(
        lambda e, s, c: ops.fused_seqpool_cvm_with_conv(e, s, c, B, S, **kw),
        [emb, segs, cvm_in], g, (0, 2))
    want, (wemb, wcvm) = jax_run(
        lambda e, s, c: ref_seqpool.fused_seqpool_cvm_with_conv(
            e, s, c, B, S, **kw), [emb, segs, cvm_in], g, (0, 2))
    assert got.shape == want.shape == (B, S, width)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(gemb[:, :3], wemb[:, :3])
    np.testing.assert_allclose(gemb, wemb, **TOL)
    np.testing.assert_array_equal(gcvm, wcvm)
    assert not gcvm.any()


@pytest.mark.parametrize("pclk_num,pad_value", [(1, 0.0), (3, 0.25)])
def test_with_pcoc_matches_reference(pclk_num, pad_value):
    E, P = 4, pclk_num
    emb, segs = batch(4 + P + E, 5, 4 + P)
    rng = np.random.default_rng(6)
    cvm_in = rng.integers(0, 3, size=(B, 4)).astype(np.float32)
    q = rng.uniform(size=(B, P)).astype(np.float32)
    g = rng.normal(size=(B, S, 2 + 2 * P + E)).astype(np.float32)
    got, (gemb, gcvm, gq) = torch_run(
        lambda e, s, c, qv: ops.fused_seqpool_cvm_with_pcoc(
            e, s, c, qv, B, S, P, pad_value=pad_value),
        [emb, segs, cvm_in, q], g, (0, 2, 3))
    want, (wemb, wcvm, wq) = jax_run(
        lambda e, s, c, qv: ref_seqpool.fused_seqpool_cvm_with_pcoc(
            e, s, c, qv, B, S, P, pad_value=pad_value),
        [emb, segs, cvm_in, q], g, (0, 2, 3))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(gemb[:, :4 + P], wemb[:, :4 + P])
    np.testing.assert_allclose(gemb, wemb, **TOL)
    for a, b in ((gcvm, wcvm), (gq, wq)):
        np.testing.assert_array_equal(a, b)
        assert not a.any()


@pytest.mark.parametrize("use_cvm", [True, False])
def test_cvm_matches_reference(use_cvm):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(5, 4, 6)).astype(np.float32)
    x[..., :2] = rng.integers(0, 9, size=(5, 4, 2))
    cvm_in = rng.integers(0, 3, size=(5, 4, 2)).astype(np.float32)
    g = rng.normal(size=(5, 4, 6 if use_cvm else 4)).astype(np.float32)
    got, (gx, gc) = torch_run(lambda a, c: ops.cvm(a, c, use_cvm),
                              [x, cvm_in], g, (0, 1))
    want, (wx, wc) = jax_run(lambda a, c: ref_cvm(a, c, use_cvm),
                             [x, cvm_in], g, (0, 1))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(gx[..., :2], wx[..., :2])
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gc, wc)


def test_width_errors_match_reference():
    emb, segs = batch(9, 8, 4)
    e, s = torch.from_numpy(emb), torch.from_numpy(segs)
    cases = [
        (lambda: ops.fused_seqpool_cvm_with_conv(
            e, s, torch.zeros(B, 2), B, S),
         lambda: ref_seqpool.fused_seqpool_cvm_with_conv(
             emb, segs, np.zeros((B, 2), np.float32), B, S)),
        (lambda: ops.fused_seqpool_cvm_with_pcoc(
            e, s, torch.zeros(B, 3), torch.zeros(B, 1), B, S, 1),
         lambda: ref_seqpool.fused_seqpool_cvm_with_pcoc(
             emb, segs, np.zeros((B, 3), np.float32),
             np.zeros((B, 1), np.float32), B, S, 1)),
        (lambda: ops.fused_seqpool_cvm_with_pcoc(
            e, s, torch.zeros(B, 4), torch.zeros(B, 2), B, S, 1),
         lambda: ref_seqpool.fused_seqpool_cvm_with_pcoc(
             emb, segs, np.zeros((B, 4), np.float32),
             np.zeros((B, 2), np.float32), B, S, 1)),
    ]
    for port, ref in cases:
        with pytest.raises(ValueError) as ref_err:
            ref()
        with pytest.raises(ValueError) as port_err:
            port()
        assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("shuffle", [False, True])
def test_variant_pool_sums_in_key_order(shuffle):
    """The variants pool with no atomics: each (row, slot) summed from 0 in
    key order, ids in any order, padding dropped. So the pooled columns
    (with_conv's tail, unchanged by the CVM head) equal a sequential
    ``index_add_`` over the same key order bit for bit, on every run."""
    emb, segs = batch(3 + 5, 11, 3)
    if shuffle:
        perm = np.random.default_rng(12).permutation(NPAD)
        emb, segs = emb[perm], segs[perm]
    e, s = torch.from_numpy(emb), torch.from_numpy(segs)
    cvm_in = torch.zeros(B, 3)
    got = ops.fused_seqpool_cvm_with_conv(e, s, cvm_in, B, S, use_cvm=False,
                                          pad_value=0.25)
    want = torch.zeros(B * S + 1, 3 + 5).index_add_(0, s.long(), e)
    want = (want[:B * S] + 0.25).reshape(B, S, -1)[..., 3:]
    assert torch.equal(got, want)
    assert torch.equal(got, ops.fused_seqpool_cvm_with_conv(
        e, s, cvm_in, B, S, use_cvm=False, pad_value=0.25))
