"""The port's mesh (``paddlebox_tpu_torch/parallel/``) on the CPU: the mesh
and its two collectives, the plan's gradient helpers, ``split_batch``
against the reference's, and the owner hash of the device-sharded table
in its three implementations (torch, numpy, the port's C++ planner)
against the reference's ``host_owner_hash`` and its native planner, on
10^5 uint64 keys that use every high bit. Everything here is exact."""

import numpy as np
import pytest
import torch

from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.data.batch import CsrBatch as JaxCsrBatch
from paddlebox_tpu.parallel import make_mesh as jax_make_mesh
from paddlebox_tpu.parallel.dp_step import split_batch as jax_split_batch
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu.ps.device_index import \
    host_owner_hash as ref_host_owner_hash
from paddlebox_tpu.ps.sharded_device_table import \
    ShardedDeviceTable as JaxShardedTable
from paddlebox_tpu_torch import parallel
from paddlebox_tpu_torch.config import TableConfig
from paddlebox_tpu_torch.data.batch import CsrBatch
from paddlebox_tpu_torch.parallel.dp_step import split_batch
from paddlebox_tpu_torch.parallel.mesh import AXIS_DP, Mesh, make_mesh
from paddlebox_tpu_torch.parallel.plan import (Plan, PlanError,
                                               global_denominator,
                                               reduce_gradients, reduce_loss)
from paddlebox_tpu_torch.ps import native
from paddlebox_tpu_torch.ps.device_index import (device_owner_hash,
                                                 host_owner_hash, key_halves)
from paddlebox_tpu_torch.ps.sharded_device_table import (ShardedDeviceTable,
                                                         shard_of)

N_KEYS = 100_000
TABLE = dict(embedx_dim=4, cvm_offset=3, embedx_threshold=0.0,
             initial_range=0.0, seed=3)


def all_bit_keys(seed: int, n: int = N_KEYS) -> np.ndarray:
    """uint64 keys, non-zero, half of them at or above 2^63, with keys
    that differ in one high bit from others."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, np.iinfo(np.uint64).max, size=n, dtype=np.uint64,
                        endpoint=True)
    keys[:1000] = keys[1000:2000] ^ (np.uint64(1) << np.uint64(63))
    keys[2000:2064] = np.uint64(1) << np.arange(64, dtype=np.uint64)
    return keys


@pytest.mark.parametrize("ndev", [1, 3, 4])
def test_all_to_all_is_the_block_transpose(ndev):
    rng = np.random.default_rng(ndev)
    x = rng.normal(size=(ndev, ndev, 5, 2)).astype(np.float32)
    mesh = make_mesh(ndev, device="cpu")
    out = mesh.all_to_all([torch.from_numpy(x[d]) for d in range(ndev)])
    want = x.transpose(1, 0, 2, 3)
    assert len(out) == ndev
    for s in range(ndev):
        np.testing.assert_array_equal(out[s].numpy(), want[s])


def test_psum_adds_in_shard_order():
    """((x0 + x1) + x2) + x3 in float32, which another order would not
    give: 1e8 + 1 rounds back to 1e8."""
    mesh = make_mesh(4, device="cpu")
    xs = [torch.tensor([v], dtype=torch.float32)
          for v in (1e8, 1.0, -1e8, 1.0)]
    assert float(mesh.psum(xs)) == 1.0
    # ((1 - 1e8) + 1) + 1e8: each 1 rounds away
    assert float(mesh.psum(xs[::-1])) == 0.0
    assert float(make_mesh(1, device="cpu").psum(xs[:1])) == 1e8
    with pytest.raises(ValueError, match="psum takes 4"):
        mesh.psum(xs[:3])


def test_mesh_and_plan():
    mesh = make_mesh(4, device="cpu")
    assert mesh.size == len(mesh) == 4 and mesh.shape == {AXIS_DP: 4}
    assert mesh.devices == [torch.device("cpu")] * 4
    assert Mesh(["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError, match="axis"):
        Mesh(["cpu"], axis_names=("rows",))
    plan = Plan.data_parallel(mesh)
    assert plan.data_axis == plan.table_axis == AXIS_DP
    with pytest.raises(PlanError):
        Plan(mesh=mesh, data_axis="mp")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh()
    # the package's names resolve lazily
    assert parallel.make_mesh is make_mesh
    assert "FusedShardedTrainStep" in dir(parallel)


def test_gradient_helpers_sum_over_shards():
    mesh = make_mesh(3, device="cpu")
    xs = [torch.tensor(float(i + 1)) for i in range(3)]
    assert float(global_denominator(xs, mesh)) == 6.0
    assert float(reduce_loss(xs, mesh)) == 6.0
    g = [[torch.full((2,), float(d)), None] for d in range(3)]
    out = reduce_gradients(g, mesh)
    np.testing.assert_array_equal(out[0].numpy(), [3.0, 3.0])
    assert out[1] is None


@pytest.mark.parametrize("ndev", [2, 4])
def test_split_batch_matches_reference(ndev):
    rng = np.random.default_rng(ndev)
    B, S, Dd, npad = 8, 3, 2, 128
    lengths = rng.integers(0, 4, size=(B, S)).astype(np.int32)
    n = int(lengths.sum())
    keys = np.zeros(npad, np.uint64)
    keys[:n] = rng.integers(1, 1 << 40, size=n)
    segs = np.full(npad, B * S, np.int32)
    segs[:n] = np.repeat(np.arange(B * S, dtype=np.int32),
                         lengths.reshape(-1))
    kw = dict(keys=keys, segment_ids=segs, lengths=lengths,
              labels=rng.uniform(size=B).astype(np.float32),
              dense=rng.normal(size=(B, Dd)).astype(np.float32),
              batch_size=B, num_slots=S, num_keys=n, num_rows=B - 1)
    got = split_batch(CsrBatch(**kw), ndev)
    want = jax_split_batch(JaxCsrBatch(**kw), ndev)
    for f in ("keys", "segment_ids", "labels", "dense", "row_mask",
              "num_keys"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.batch_size, got.num_slots, got.ndev) == \
        (want.batch_size, want.num_slots, want.ndev)
    with pytest.raises(ValueError, match="not divisible"):
        split_batch(CsrBatch(**kw), 3)


def test_owner_hash_torch_numpy_reference_agree():
    keys = all_bit_keys(0)
    want = ref_host_owner_hash(keys)
    np.testing.assert_array_equal(host_owner_hash(keys), want)
    hi, lo = key_halves(torch.from_numpy(keys.view(np.int64)))
    got = device_owner_hash(hi, lo).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() < 2 ** 32
    for n in (2, 7, 8):
        np.testing.assert_array_equal(
            shard_of(keys, n), (want % np.uint32(n)).astype(np.int32))


@pytest.mark.parametrize("ndev", [7, 8])
def test_native_planner_owners_match_reference(ndev):
    """The C++ planner's owner of every key (its request bucket, inverse
    // R) equals ``shard_of``'s and the reference planner's, at a power of
    two (a mask) and at 7 (a modulo)."""
    if not (native.available() and ref_native.available()):
        pytest.skip("the native index core does not build here")
    keys = all_bit_keys(ndev)
    npad = -(-N_KEYS // ndev)
    grid = np.zeros(ndev * npad, np.uint64)
    grid[:N_KEYS] = keys
    grid = grid.reshape(ndev, npad)
    port = ShardedDeviceTable(TableConfig(**TABLE),
                              make_mesh(ndev, device="cpu"),
                              capacity_per_shard=1 << 15, backend="native")
    ref = JaxShardedTable(JaxTableConfig(**TABLE), jax_make_mesh(ndev),
                          capacity_per_shard=1 << 15, backend="native")
    got = port.prepare_batch(grid)
    want = ref.prepare_batch(grid)
    np.testing.assert_array_equal(got.inverse, want.inverse)
    owners = shard_of(grid.reshape(-1), ndev).reshape(grid.shape)
    live = grid != 0
    np.testing.assert_array_equal((got.inverse // got.R)[live],
                                  owners[live])
    assert port._sizes == ref._sizes
    assert sum(port.shard_sizes()) == np.unique(keys).size
