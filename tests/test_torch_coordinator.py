"""The port's host transport (``paddlebox_tpu_torch/parallel/coordinator.py``)
against the reference's ``Coordinator``: the collectives on ranks as
threads (the reference's ``tests/test_coordinator.py`` cases), the array
blobs byte for byte, a world of one port rank and one reference rank (the
same wire), the heartbeat's dead-rank detection and abort, and the dense
mean hook against the reference test's ``sync_params_mean``, bit for bit
(the coordinator shuffle and merge: ``tests/test_torch_dataset_ops.py``)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.parallel import coordinator as ref_coord
from paddlebox_tpu_torch.models.convert import (deepfm_from_flax_leaves,
                                                flax_leaves_from_model)
from paddlebox_tpu_torch.parallel.coordinator import (Coordinator,
                                                      dense_mean_hook,
                                                      local_endpoints,
                                                      np_from_bytes,
                                                      np_to_bytes)
from test_multihost_multichip import sync_params_mean
from torch_coord_world import run_ranks, world

WORLD = 3


def port_world(n=WORLD):
    return world("port", n)


def test_send_recv():
    def fn(rank, c):
        c.send((rank + 1) % WORLD, "hello", f"from{rank}".encode())
        return c.recv((rank - 1) % WORLD, "hello").decode()

    assert run_ranks(fn, port_world()) == [f"from{(r - 1) % WORLD}"
                                           for r in range(WORLD)]


def test_barrier_and_all_gather():
    def fn(rank, c):
        c.barrier("x")
        parts = c.all_gather(np_to_bytes(np.array([rank * 10])))
        return [int(np_from_bytes(p)[0][0]) for p in parts]

    assert run_ranks(fn, port_world()) == [[0, 10, 20]] * WORLD


def test_alltoall():
    def fn(rank, c):
        with pytest.raises(ValueError, match="need 3 blobs"):
            c.alltoall([b""])
        return [b.decode() for b in c.alltoall(
            [f"{rank}->{j}".encode() for j in range(WORLD)])]

    res = run_ranks(fn, port_world())
    for r in range(WORLD):
        assert res[r] == [f"{j}->{r}" for j in range(WORLD)]


def test_allreduce_sum():
    res = run_ranks(lambda rank, c: c.allreduce_sum(np.full(4, rank + 1.0)),
                    port_world())
    for r in res:
        np.testing.assert_array_equal(r, np.full(4, 6.0))


BLOBS = {
    "one_f32": (np.arange(12, dtype=np.float32).reshape(3, 4),),
    "keys_and_rows": (np.array([1, 2 ** 63 + 5, 7], np.uint64),
                      np.linspace(-1, 1, 21, dtype=np.float32).reshape(3, 7)),
    "empty": (np.empty(0, np.uint64), np.zeros((0, 7), np.float32)),
    "none": (),
    "f64_noncontiguous": (np.arange(20.0).reshape(4, 5)[:, ::2],),
}


@pytest.mark.parametrize("case", sorted(BLOBS))
def test_np_to_bytes_matches_reference(case):
    arrays = BLOBS[case]
    blob = np_to_bytes(*arrays)
    assert blob == ref_coord.np_to_bytes(*arrays)
    back = np_from_bytes(ref_coord.np_to_bytes(*arrays))
    assert len(back) == len(arrays)
    for a, b in zip(back, arrays):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_mixed_world_speaks_the_reference_wire():
    """Rank 0 a port ``Coordinator``, rank 1 the reference's: an
    ``alltoall`` of array blobs, a barrier and an ``allreduce_sum``."""
    eps = local_endpoints(2)
    coords = [Coordinator(0, eps), ref_coord.Coordinator(1, eps)]

    def fn(rank, c):
        mine = [np_to_bytes(np.full(3, 10 * rank + j, np.int64))
                for j in range(2)]
        got = [np_from_bytes(b)[0] for b in c.alltoall(mine, "mix")]
        c.barrier("mixed")
        return got, c.allreduce_sum(np.array([rank + 0.5]), "sum")

    res = run_ranks(fn, coords)
    for r, (got, total) in enumerate(res):
        for j in range(2):
            np.testing.assert_array_equal(got[j], np.full(3, 10 * j + r))
        np.testing.assert_array_equal(total, [2.0])


def test_dead_rank_detected():
    eps = local_endpoints(2)
    a, b = Coordinator(0, eps), Coordinator(1, eps)
    try:
        assert a.dead_ranks() == []
        a.start_heartbeat(interval=0.1)
        b.start_heartbeat(interval=0.1)
        time.sleep(0.5)
        assert a.dead_ranks(timeout=0.4) == []
        b.close()
        time.sleep(0.8)
        assert a.dead_ranks(timeout=0.4) == [1]
    finally:
        a.close()
        b.close()


def test_dead_rank_aborts_blocked_collective():
    """A dead peer makes the survivor's blocked recv raise, naming it,
    well within the recv's own timeout; a recv after the abort raises at
    once."""
    eps = local_endpoints(2)
    a, b = Coordinator(0, eps), Coordinator(1, eps)
    try:
        a.start_heartbeat(interval=0.1, abort_timeout=0.5)
        b.start_heartbeat(interval=0.1)
        time.sleep(0.3)
        b.close()
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match=r"dead ranks: \[1\]"):
            a.recv(1, "never-sent", timeout=30.0)
        assert time.monotonic() - t0 < 10.0
        assert a.aborted_dead == [1]
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="closed"):
            a.recv(1, "after", timeout=30.0)
        assert time.monotonic() - t0 < 1.0
    finally:
        a.close()
        b.close()


def test_dense_mean_hook_matches_reference_sync():
    """Two ranks' differing DeepFM weights averaged by ``dense_mean_hook``
    (in place) and by the reference test's ``sync_params_mean`` over a
    reference world: the same float32 bits."""
    rng = np.random.default_rng(0)
    params = [FlaxDeepFM(hidden=(16, 8)).init(
        jax.random.PRNGKey(r), jnp.zeros((4, 3, 7)), jnp.zeros((4, 2)))
        for r in range(2)]
    params = [jax.tree_util.tree_map(
        lambda x: x + rng.normal(scale=0.3, size=x.shape).astype(x.dtype), p)
        for p in params]
    ref = run_ranks(lambda r, c: sync_params_mean(params[r], c),
                    world("ref", 2))
    models = [deepfm_from_flax_leaves(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(p)], (16, 8))
        for p in params]
    coords = port_world(2)
    hooks = [dense_mean_hook(c) for c in coords]
    out = run_ranks(lambda r, c: hooks[r](models[r]), coords)
    assert out[0] is models[0]
    for r in range(2):
        want = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref[r])]
        got = flax_leaves_from_model(models[r])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert all(p.dtype == torch.float32 for p in models[0].parameters())
