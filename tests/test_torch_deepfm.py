"""Port's DeepFM with weights converted from the flax params vs the flax
DeepFM, plus the converter and the leaf-file round trips.

Tolerance atol=1e-5: both run float32 GEMMs, in another summation order."""

import jax
import numpy as np
import pytest
import torch

from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.utils.checkpoint import load_pytree, save_pytree
from paddlebox_tpu_torch.models.convert import (deepfm_from_flax_leaves,
                                                flax_leaves_from_deepfm)
from paddlebox_tpu_torch.utils.checkpoint import load_leaves, save_leaves


def flax_params(hidden, S, D, Dd, seed, perturb):
    model = FlaxDeepFM(hidden=hidden)
    params = model.init(jax.random.PRNGKey(seed), np.zeros((2, S, D),
                                                            np.float32),
                        np.zeros((2, Dd), np.float32))
    if perturb:
        # flax inits every bias to zero; random leaves pin the bias mapping
        rng = np.random.default_rng(seed)
        leaves, treedef = jax.tree_util.tree_flatten(params)
        leaves = [(rng.normal(size=np.shape(x)) * 0.1).astype(np.float32)
                  for x in leaves]
        params = jax.tree_util.tree_unflatten(treedef, leaves)
    return model, params


def inputs(seed, B, S, D, Dd):
    # the scale of pooled embeddings and log1p'd dense features
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(B, S, D)) * 0.1).astype(np.float32),
            (rng.normal(size=(B, Dd)) * 0.5).astype(np.float32))


@pytest.mark.parametrize("perturb", [False, True])
@pytest.mark.parametrize("hidden,S,D,Dd", [
    ((16, 8), 4, 11, 3),
    ((512, 256, 128), 26, 11, 13),        # the flagship's full width
    ((4,) * 11, 3, 11, 0),                # Dense_10 sorts before Dense_2
])
def test_logits_match_flax(hidden, S, D, Dd, perturb):
    model, params = flax_params(hidden, S, D, Dd, 0, perturb)
    sparse, dense = inputs(1, 8, S, D, Dd)
    want = np.asarray(model.apply(params, sparse, dense))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    port = deepfm_from_flax_leaves(leaves, hidden)
    with torch.no_grad():
        got = port(torch.from_numpy(sparse), torch.from_numpy(dense)).numpy()
    assert got.shape == want.shape == (8,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_converter_round_trip_is_exact():
    _, params = flax_params((16, 8), 4, 11, 3, 2, True)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    back = flax_leaves_from_deepfm(deepfm_from_flax_leaves(leaves, (16, 8)))
    assert len(back) == len(leaves)
    for a, b in zip(back, leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_converter_rejects_wrong_leaf_count():
    _, params = flax_params((16, 8), 4, 11, 3, 0, False)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    with pytest.raises(ValueError, match="leaves"):
        deepfm_from_flax_leaves(leaves[:-1], (16, 8))
    with pytest.raises(ValueError, match="leaves"):
        deepfm_from_flax_leaves(leaves, (16, 8, 4))


def test_leaf_files_cross_between_packages(tmp_path):
    _, params = flax_params((16, 8), 4, 11, 3, 3, True)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    # reference writes, port reads
    save_pytree(str(tmp_path / "jax.npz"), params)
    got = load_leaves(str(tmp_path / "jax.npz"), leaves)
    for a, b in zip(got, leaves):
        np.testing.assert_array_equal(a, b)
    # port writes, reference reads
    save_leaves(str(tmp_path / "port.npz"), leaves)
    back = load_pytree(str(tmp_path / "port.npz"), params)
    for a, b in zip(jax.tree_util.tree_leaves(back), leaves):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_leaf_file_validation(tmp_path):
    leaves = [np.zeros(3, np.float32), np.zeros((2, 3), np.float32)]
    path = str(tmp_path / "p.npz")
    save_leaves(path, leaves)
    with pytest.raises(ValueError, match="missing keys"):
        load_leaves(path, leaves + [np.zeros(1, np.float32)])
    with pytest.raises(ValueError, match="unexpected keys"):
        load_leaves(path, leaves[:1])
    with pytest.raises(ValueError, match="shape"):
        load_leaves(path, [np.zeros(4, np.float32), leaves[1]])
    with pytest.raises(ValueError, match="dtype"):
        load_leaves(path, [np.zeros(3, np.float64), leaves[1]])
