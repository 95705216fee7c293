"""The port's device index (``paddlebox_tpu_torch/ps/device_index.py``) on
the CPU against the reference's (``paddlebox_tpu/ps/device_index.py``):
the plain hash bit for bit, the plain dedup exactly, and the plain probe
over the port's one-level mirror exactly as the reference's two-level
mirror answers, after inserts and after a growth; the plain fused dedup
and probe exactly as the reference's dedup followed by its probe of the
uniques. The CUDA wrappers refuse CPU tensors (no fallback); on the card
``chip_smoke.py`` holds K5, K6 and the fused pass against these plain
versions.

The mirror tests need both packages' index cores (g++)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paddlebox_tpu.ps import device_index as ref
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu_torch.ops import device_index_kernel as kernel
from paddlebox_tpu_torch.ops.sparse_push import merge_order_plain
from paddlebox_tpu_torch.ps import device_index, native

HIGH = np.uint64(1) << np.uint64(63)
RESERVED = np.iinfo(np.uint64).max  # ~0: the host map cannot hold it
needs_native = pytest.mark.skipif(not ref_native.available(),
                                  reason="native backend unavailable")


def as_torch(keys: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(keys, np.uint64).view(
        np.int64))


def high_keys(rng, n):
    keys = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    keys[::3] |= HIGH
    keys[::5] &= np.uint64(0xFFFFFFFF)
    keys[:4] = [0, 1, RESERVED, HIGH]
    return keys


def insertable(keys):
    return keys[keys != RESERVED]


def test_hash_matches_reference():
    keys = high_keys(np.random.default_rng(0), 5000)
    khi, klo = device_index.key_halves(as_torch(keys))
    got = device_index.device_hash(khi, klo).numpy()
    assert got.min() >= 0 and got.max() < 1 << 32
    np.testing.assert_array_equal(got.astype(np.uint32), ref.host_hash(keys))
    np.testing.assert_array_equal(device_index.host_hash(keys),
                                  ref.host_hash(keys))
    jhi, jlo = ref.split_keys(keys)
    np.testing.assert_array_equal(got.astype(np.uint32), np.asarray(
        ref.device_hash(jnp.asarray(jhi), jnp.asarray(jlo))))
    for a, b in zip(device_index.split_keys(keys), (jhi, jlo)):
        np.testing.assert_array_equal(a, b)


def dedup_cases():
    rng = np.random.default_rng(1)
    dup = rng.integers(0, 300, size=4096).astype(np.uint64)
    mixed = high_keys(rng, 3000)
    mixed[rng.integers(0, 3000, size=600)] = mixed[rng.integers(0, 3000,
                                                                size=600)]
    return {"duplicates-and-zeros": dup, "high-keys": mixed,
            "all-padding": np.zeros(1000, np.uint64),
            "one-key-repeated": np.full(777, 5, np.uint64),
            "one-key": np.array([HIGH], np.uint64)}


def check_dedup_against_reference(keys, got=None):
    """``got`` (the port's plain dedup of ``keys`` by default) against the
    reference's ``device_dedup``; returns the reference's uniques."""
    if got is None:
        got = device_index.device_dedup(as_torch(keys))
    jhi, jlo = ref.split_keys(keys)
    inv, uhi, ulo, nu = ref.device_dedup(jnp.asarray(jhi), jnp.asarray(jlo))
    np.testing.assert_array_equal(got.inverse.numpy(), np.asarray(inv))
    assert got.inverse.dtype == torch.int32
    assert int(got.n_uniq) == int(nu)
    ghi, glo = device_index.split_keys(got.uniq_keys.numpy().view(np.uint64))
    np.testing.assert_array_equal(ghi, np.asarray(uhi))
    np.testing.assert_array_equal(glo, np.asarray(ulo))
    # the sorted positions and offsets are the push's merge order
    order, offsets = merge_order_plain(got.inverse, keys.size)
    np.testing.assert_array_equal(got.order.numpy(), order.numpy())
    np.testing.assert_array_equal(got.offsets.numpy(), offsets.numpy())
    return uhi, ulo


@pytest.mark.parametrize("case", sorted(dedup_cases()))
def test_dedup_plain_matches_reference(case):
    check_dedup_against_reference(dedup_cases()[case])


@functools.lru_cache(maxsize=None)
def radix_cases():
    """The batches ``chip_smoke.py`` runs through K5 at its default seed."""
    return chip_smoke.radix_cases(np.random.default_rng([0, 9]))


def active_digits(keys):
    plan = device_index.radix_plan_plain(as_torch(keys))
    assert plan.dtype == torch.int32 and plan.shape == (2 * kernel.DIGITS
                                                        + 1,)
    return [d for d in range(kernel.DIGITS) if plan[d]]


@pytest.mark.parametrize("byte", range(8))
def test_dedup_plain_keys_differing_in_one_byte(byte):
    """Only the varying byte's digit is active: the seven passes skipped
    on the card must leave the keys where the one before left them."""
    keys = radix_cases()[f"byte-{byte}"]
    assert active_digits(keys) == [byte]
    check_dedup_against_reference(keys)


def test_dedup_plain_keys_straddling_the_sign_bit():
    """Keys on both sides of 2^63 (byte 7 is 0x7F or 0x80) with one bin of
    the lowest digit: unsigned order puts 2^63 and above last."""
    keys = radix_cases()["straddle-2^63"]
    high = keys >= HIGH
    assert high.any() and (~high).any()
    assert 0 not in active_digits(keys) and 7 in active_digits(keys)
    check_dedup_against_reference(keys)
    got = device_index.device_dedup(as_torch(keys))
    uniq = got.uniq_keys[:int(got.n_uniq)].numpy().view(np.uint64)
    assert (np.diff(uniq) > 0).all() and uniq[-1] >= HIGH > uniq[0]


@pytest.mark.parametrize("n", [2047, 2048, 2049])
def test_dedup_plain_around_a_sort_tile(n):
    keys = radix_cases()[f"n-{n}"]
    assert keys.size == n
    assert active_digits(keys) == list(range(8))
    check_dedup_against_reference(keys)


def test_radix_plan_plain_skips_digits_with_one_bin():
    """The plan: inactive digits move nothing, so each active pass reads
    the buffer the active pass before it wrote."""
    keys = np.array([0x0102, 0x0103, 0x0502], np.uint64)
    plan = device_index.radix_plan_plain(as_torch(keys)).tolist()
    assert plan[:8] == [1, 1, 0, 0, 0, 0, 0, 0]
    assert plan[8:16] == [0, 1, 0, 0, 0, 0, 0, 0]
    assert plan[16] == 0
    plan = device_index.radix_plan_plain(as_torch(np.zeros(5, np.uint64)))
    assert plan.tolist() == [0] * 17


def test_dedup_of_no_keys():
    got = device_index.device_dedup(torch.zeros(0, dtype=torch.int64))
    assert int(got.n_uniq) == 0 and got.offsets.tolist() == [0]


def mirrors(seed=2, n0=3000):
    """The reference's and the port's index and mirror over the same
    keys."""
    rng = np.random.default_rng(seed)
    ri, pi = ref_native.NativeIndex(), native.NativeIndex()
    keys = insertable(high_keys(rng, n0))
    ri.prepare(keys, True, True, 1)
    pi.prepare(keys, True, True, 1)
    return (rng, keys, (ri, ref.DeviceIndexMirror(ri)),
            (pi, device_index.DeviceIndexMirror(pi, "cpu")))


def probe_both(rm, pm, keys, n_valid=None):
    jhi, jlo = ref.split_keys(keys)
    rrow, rfound = rm.probe(jnp.asarray(jhi), jnp.asarray(jlo))
    rrow, rfound = np.array(rrow), np.array(rfound)
    # the port never finds key 0 or the reserved key ~0 (the reference's
    # gather would count ~0 as found at row 0, in an empty slot)
    rfound &= (keys != 0) & (keys != RESERVED)
    if n_valid is not None:
        rrow[n_valid:], rfound[n_valid:] = 0, False
        n_valid = torch.tensor(n_valid, dtype=torch.int32)
    prow, pfound = pm.probe(as_torch(keys), n_valid)
    assert prow.dtype == torch.int32 and pfound.dtype == torch.bool
    np.testing.assert_array_equal(prow.numpy(), rrow)
    np.testing.assert_array_equal(pfound.numpy(), rfound)
    return prow.numpy(), pfound.numpy()


@needs_native
def test_probe_plain_matches_reference_mirror():
    rng, keys, (ri, rm), (pi, pm) = mirrors()
    np.testing.assert_array_equal(pm.tab.numpy().view(np.uint32),
                                  np.asarray(rm.tab))
    assert pm.mask == rm.mask and pm.window == rm.window == 64
    query = np.concatenate([keys, high_keys(rng, 500)])
    rows, found = probe_both(rm, pm, query)
    want, _ = pi.lookup(query, False, True, 0)
    np.testing.assert_array_equal(rows, np.maximum(want, 0))
    assert found[:keys.size][keys != 0].all()
    probe_both(rm, pm, query, n_valid=1000)


@needs_native
def test_probe_after_inserts_matches_reference():
    """Inserts small enough to stay in the map's capacity: the port writes
    them into its one table, the reference into its mini level."""
    rng, keys, (ri, rm), (pi, pm) = mirrors(3, 3000)
    tab = pm.tab
    new = insertable(high_keys(rng, 400))
    a = ri.prepare_dev(new, True, True, 1 + len(ri))
    b = pi.prepare_dev(new, True, True, 1 + len(pi))
    assert ri.generation == pi.generation == pm.generation
    rm.apply_updates(*a[4:])
    pm.apply_updates(*b[4:])
    assert pm.tab is tab  # in place
    np.testing.assert_array_equal(pm.tab.numpy().view(np.uint32),
                                  pi.export_slots())
    rows, found = probe_both(rm, pm, np.concatenate([keys, new]))
    assert found[np.concatenate([keys, new]) != 0].all()


@needs_native
def test_probe_after_growth_resync_matches_reference():
    rng, keys, (ri, rm), (pi, pm) = mirrors(4, 300)
    gen = pm.generation
    new = rng.integers(1, 1 << 62, size=20000).astype(np.uint64)
    a = ri.prepare_dev(new, True, True, 1 + len(ri))
    b = pi.prepare_dev(new, True, True, 1 + len(pi))
    rm.apply_updates(*a[4:])
    pm.apply_updates(*b[4:])
    assert pi.generation > gen and pm.generation == pi.generation
    assert pm.tab.shape == (pi.capacity + pi.guard, 4)
    assert pm.memory_bytes() == pm.tab.shape[0] * 16
    rows, found = probe_both(rm, pm, np.concatenate([keys, new]))
    np.testing.assert_array_equal(rows[keys.size:], b[0])


def mirror_pair(keys):
    """The reference's and the port's index and mirror over the same
    keys."""
    ri, pi = ref_native.NativeIndex(), native.NativeIndex()
    ri.prepare(keys, True, True, 1)
    pi.prepare(keys, True, True, 1)
    return (ri, ref.DeviceIndexMirror(ri)), (pi, device_index.DeviceIndexMirror(
        pi, "cpu"))


def dedup_probe_cases():
    """Each case: (keys the index holds, a batch of keys)."""
    rng = np.random.default_rng(10)
    vocab = np.arange(1, 5001, dtype=np.uint64)
    batch = rng.integers(1, 5001, size=4096).astype(np.uint64)
    batch[-400:] = 0  # the padding of a bucket
    highs = insertable(high_keys(rng, 3000))
    mixed = np.concatenate([rng.choice(highs, 2000), high_keys(rng, 500)])
    absent = np.concatenate([
        rng.integers(5001, 1 << 62, size=2000).astype(np.uint64),
        rng.integers(1, 5001, size=500).astype(np.uint64),
        np.array([0, 0, 7], np.uint64)])
    # 64 keys with one home slot fill its window; the 65th is absent and
    # its walk ends at the window
    run = chip_smoke.colliding_keys(native.NativeIndex().capacity - 1, 100,
                                    65, rng)
    crowd = np.concatenate([run, run[::-3], np.zeros(1, np.uint64)])
    assert all(k.dtype == np.uint64 for k in (mixed, absent, crowd))
    return {"training-like": (vocab, batch),
            "high-keys": (highs, mixed[rng.permutation(mixed.size)]),
            "all-padding": (vocab, np.zeros(1000, np.uint64)),
            "absent-keys": (vocab, absent[rng.permutation(absent.size)]),
            "colliding-run-to-window": (run[:64], crowd)}


@needs_native
@pytest.mark.parametrize("case", sorted(dedup_probe_cases()))
def test_dedup_probe_plain_matches_reference(case):
    """The fused dedup and probe's plain version against the reference's
    ``device_dedup`` followed by ``device_probe`` of its uniques, over the
    same index: every field of the dedup, rows and found exactly."""
    held, keys = dedup_probe_cases()[case]
    (ri, rm), (pi, pm) = mirror_pair(held)
    if case == "colliding-run-to-window":
        cap = pi.capacity
        slots = pi.export_slots()
        last = max(int(np.flatnonzero(
            (slots[:, 0] == (k >> np.uint64(32))) &
            (slots[:, 1] == (k & np.uint64(0xFFFFFFFF))))[0]) for k in held)
        assert cap == native.NativeIndex().capacity and last == 100 + 63
    dd, rows, found = device_index.device_dedup_probe_plain(
        as_torch(keys), pm.tab, pm.mask, pm.window)
    uhi, ulo = check_dedup_against_reference(keys, dd)
    rrow, rfound = ref.device_probe(rm.tab, rm.mask, rm.window, uhi, ulo)
    rrow, rfound = np.array(rrow), np.array(rfound)
    uniq = dd.uniq_keys.numpy().view(np.uint64)
    rfound &= (uniq != 0) & (uniq != RESERVED)  # as in probe_both
    assert rows.dtype == torch.int32 and found.dtype == torch.bool
    np.testing.assert_array_equal(rows.numpy(), rrow)
    np.testing.assert_array_equal(found.numpy(), rfound)
    nu = int(dd.n_uniq)
    assert not rows[nu:].any() and not found[nu:].any()
    # the mirror's entry is the same function
    got = pm.dedup_probe(as_torch(keys))
    for a, b in zip((*got[0], *got[1:]), (*dd, rows, found)):
        assert torch.equal(a, b)
    if case == "training-like":
        assert found[1:nu].all() and not found[0]  # uid 0 is the padding
    if case == "colliding-run-to-window":
        assert int(found.sum()) == 64


def test_mirror_needs_the_single_map():
    if not native.available():
        pytest.skip("native backend unavailable")
    with pytest.raises(TypeError, match="single-map"):
        device_index.DeviceIndexMirror(native.MtIndex(2), "cpu")


def test_cuda_wrappers_refuse_cpu_tensors():
    """No fallback: the kernels' wrappers never run the plain versions."""
    keys = as_torch(np.arange(8, dtype=np.uint64))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.device_dedup_cuda(keys)
    tab = torch.zeros((128, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.device_probe_cuda(tab, 63, 64, keys)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.device_dedup_probe_cuda(keys, tab, 63, 64)
    assert kernel.device_dedup_cuda.launches == 0
    assert kernel.device_probe_cuda.launches == 0
    assert kernel.device_dedup_probe_cuda.launches == 0
    assert kernel.dedup_sort_cuda.launches == 0
