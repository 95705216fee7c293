"""Ring attention of the port (``paddlebox_tpu_torch/parallel/
ring_attention.py``) over a CPU ``sp`` mesh of 8 shards, against the
reference's ``ring_self_attention`` on its 8 virtual devices and both
packages' ``dense_attention``: outputs within the reference test's rtol
2e-4, atol 2e-5 (a streaming softmax in another order), causal and not;
larger logits stay finite (rtol 1e-3, atol 1e-4, as the reference's);
the gradients of q, k and v against the reference's ring's and the port's
dense attention's (rtol 2e-3, atol 2e-4, as the reference's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.parallel import make_mesh as jax_make_mesh
from paddlebox_tpu.parallel.ring_attention import \
    dense_attention as jax_dense_attention
from paddlebox_tpu.parallel.ring_attention import \
    ring_self_attention as jax_ring_self_attention
from paddlebox_tpu_torch.parallel import (dense_attention, make_mesh,
                                          ring_self_attention)

NDEV = 8


@pytest.fixture(scope="module")
def meshes():
    return (jax_make_mesh(NDEV, axis_names=("sp",)),
            make_mesh(NDEV, device="cpu", axis_names=("sp",)))


def qkv(seed, B=2, T=64, H=2, D=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, H, D)).astype(np.float32)
            for _ in range(3)]


def port(arrays, requires_grad=False):
    return [torch.from_numpy(a).requires_grad_(requires_grad)
            for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
def test_matches_reference_and_dense(meshes, causal):
    jm, pm = meshes
    arrs = qkv(1 if causal else 0)
    got = ring_self_attention(*port(arrs), pm, causal=causal).numpy()
    want = np.asarray(jax_ring_self_attention(
        *[jnp.asarray(a) for a in arrs], jm, causal=causal))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    dense = dense_attention(*port(arrs), causal=causal).numpy()
    np.testing.assert_allclose(got, dense, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        dense, np.asarray(jax_dense_attention(
            *[jnp.asarray(a) for a in arrs], causal=causal)),
        rtol=2e-4, atol=2e-5)


def test_long_sequence_stays_finite(meshes):
    jm, pm = meshes
    q, k, v = qkv(2, T=128, D=4)
    q = q * 8.0
    got = ring_self_attention(*port([q, k, v]), pm, causal=True).numpy()
    assert np.isfinite(got).all()
    want = np.asarray(jax_ring_self_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, causal=True))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_reference(meshes, causal):
    jm, pm = meshes
    arrs = qkv(3, T=32)
    ts = port(arrs, requires_grad=True)
    ring_self_attention(*ts, pm, causal=causal).sum().backward()
    want = jax.grad(lambda q, k, v: jax_ring_self_attention(
        q, k, v, jm, causal=causal).sum(), argnums=(0, 1, 2))(
        *[jnp.asarray(a) for a in arrs])
    ds = port(arrs, requires_grad=True)
    dense_attention(*ds, causal=causal).sum().backward()
    for t, w, d in zip(ts, want, ds):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(t.grad.numpy(), d.grad.numpy(),
                                   rtol=2e-3, atol=2e-4)


def test_one_shard_is_dense(meshes):
    arrs = qkv(4, T=16)
    one = make_mesh(1, device="cpu", axis_names=("sp",))
    got = ring_self_attention(*port(arrs), one, causal=True)
    want = dense_attention(*port(arrs), causal=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        ring_self_attention(*port(qkv(5, T=12)), meshes[1])
