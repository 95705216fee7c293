"""Port's MMoE and FeedDNN (``paddlebox_tpu_torch/models/mmoe.py``,
``dnn.py``) with weights converted from the flax params vs the flax
modules, and the converters (``models/convert.py``) both ways.

Tolerances: logits atol 1e-5 (float32 GEMMs and the expert einsum in
another summation order); the converters' round trips and ``flax_order``
exact."""

import jax
import numpy as np
import pytest
import torch

from paddlebox_tpu.models import FeedDNN as FlaxFeedDNN
from paddlebox_tpu.models import MMoE as FlaxMMoE
from paddlebox_tpu_torch.models import FeedDNN, MMoE
from paddlebox_tpu_torch.models.convert import (feeddnn_from_flax_leaves,
                                                flax_leaves_from_feeddnn,
                                                flax_leaves_from_mmoe,
                                                flax_leaves_from_model,
                                                flax_order,
                                                mmoe_from_flax_leaves,
                                                model_config,
                                                model_from_flax_leaves)

B, S, D = 8, 3, 7
MMOE_KW = dict(num_tasks=2, num_experts=3, expert_hidden=(16, 8),
               expert_out=6, tower_hidden=(5,))
DNN_KW = dict(hidden=(16, 12, 8))
KINDS = {
    "mmoe": (FlaxMMoE, MMoE, MMOE_KW,
             lambda leaves: mmoe_from_flax_leaves(leaves, **MMOE_KW),
             flax_leaves_from_mmoe),
    "feed_dnn": (FlaxFeedDNN, FeedDNN, DNN_KW,
                 lambda leaves: feeddnn_from_flax_leaves(leaves, **DNN_KW),
                 flax_leaves_from_feeddnn),
}


def flax_world(kind, Dd, seed=0, kw=None):
    """The flax model, params with every leaf random (flax inits biases to
    zero; random ones pin the bias mapping) and their leaf list."""
    flax_cls = KINDS[kind][0]
    model = flax_cls(**(kw or KINDS[kind][2]))
    params = model.init(jax.random.PRNGKey(seed),
                        np.zeros((2, S, D), np.float32),
                        np.zeros((2, Dd), np.float32))
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    leaves = [(rng.normal(size=np.shape(x)) * 0.3).astype(np.float32)
              for x in leaves]
    return model, jax.tree_util.tree_unflatten(treedef, leaves), leaves


def inputs(seed, Dd):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(B, S, D)) * 0.5).astype(np.float32),
            (rng.normal(size=(B, Dd)) * 0.5).astype(np.float32))


def port_logits(model, sparse, dense):
    with torch.no_grad():
        return model(torch.from_numpy(sparse),
                     torch.from_numpy(dense)).numpy()


CASES = [(k, dd) for k in sorted(KINDS) for dd in (0, 3)]


@pytest.mark.parametrize("kind,Dd", CASES)
def test_logits_match_flax(kind, Dd):
    flax_model, params, leaves = flax_world(kind, Dd)
    sparse, dense = inputs(1, Dd)
    want = np.asarray(flax_model.apply(params, sparse, dense))
    got = port_logits(KINDS[kind][3](leaves), sparse, dense)
    shape = (B, MMOE_KW["num_tasks"]) if kind == "mmoe" else (B,)
    assert got.shape == want.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,Dd", CASES)
def test_converters_round_trip_both_ways(kind, Dd):
    """flax leaves -> port -> flax leaves is exact; a port model's own
    (torch-initialized) weights -> flax leaves score alike in flax; the
    dispatcher by class name builds the same model from the bundle's
    config."""
    flax_model, params, leaves = flax_world(kind, Dd)
    port = KINDS[kind][3](leaves)
    back = KINDS[kind][4](port)
    assert len(back) == len(leaves)
    for a, b in zip(back, leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    torch.manual_seed(3)
    fresh = KINDS[kind][1](S * D + Dd, **KINDS[kind][2])
    treedef = jax.tree_util.tree_structure(params)
    fresh_params = jax.tree_util.tree_unflatten(
        treedef, flax_leaves_from_model(fresh))
    sparse, dense = inputs(2, Dd)
    np.testing.assert_allclose(
        port_logits(fresh, sparse, dense),
        np.asarray(flax_model.apply(fresh_params, sparse, dense)),
        rtol=0, atol=1e-5)
    conf = model_config(port)
    assert conf["class"] == KINDS[kind][1].__name__
    again = model_from_flax_leaves(conf["class"], conf["kwargs"], leaves,
                                   S * D + Dd)
    assert type(again) is type(port)
    for a, b in zip(flax_leaves_from_model(again), leaves):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind,Dd", CASES)
def test_flax_order_covers_every_parameter(kind, Dd):
    """``flax_order`` maps each leaf to its tensor in ``parameters()``
    (transposed for a Linear's kernel), every tensor once."""
    _, _, leaves = flax_world(kind, Dd)
    port = KINDS[kind][3](leaves)
    order = flax_order(port)
    params = list(port.parameters())
    assert sorted(j for j, _ in order) == list(range(len(params)))
    for (j, kernel), leaf in zip(order, leaves):
        x = params[j].detach().numpy()
        np.testing.assert_array_equal(x.T if kernel else x, leaf)


@pytest.mark.parametrize("kind,kw", [
    ("feed_dnn", dict(hidden=(4,) * 11)),        # Dense_10 before Dense_2
    ("mmoe", dict(num_tasks=11, num_experts=2, expert_hidden=(4,) * 10,
                  expert_out=3, tower_hidden=(3,))),   # gate_10, tower_10
])
def test_string_key_order(kind, kw):
    flax_model, params, leaves = flax_world(kind, 2, seed=4, kw=kw)
    port = model_from_flax_leaves(KINDS[kind][1].__name__, kw, leaves,
                                  S * D + 2)
    sparse, dense = inputs(5, 2)
    np.testing.assert_allclose(
        port_logits(port, sparse, dense),
        np.asarray(flax_model.apply(params, sparse, dense)), rtol=0,
        atol=1e-5)


def test_converters_reject_mismatches():
    _, _, leaves = flax_world("mmoe", 0)
    with pytest.raises(ValueError, match="leaves"):
        mmoe_from_flax_leaves(leaves[:-1], **MMOE_KW)
    with pytest.raises(ValueError, match="expected"):
        mmoe_from_flax_leaves(leaves, **dict(MMOE_KW, expert_out=7))
    with pytest.raises(ValueError, match="unknown model class"):
        model_from_flax_leaves("Bogus", {}, leaves, S * D)
    with pytest.raises(TypeError, match="flax leaf order"):
        flax_order(torch.nn.Linear(2, 2))
