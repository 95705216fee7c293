"""Expert parallelism of the port (``paddlebox_tpu_torch/parallel/
sharding.py`` ``expert_shardings``) on a CPU ``ep`` mesh of 4 shards,
against the reference's MMoE (its flax params, converted) and its
``expert_shardings`` over its virtual devices: the stacked experts split
E / 4 a shard, the rest replicated; the forward within rtol 1e-5, atol
1e-6 of the reference's; 8 adam steps within 1e-5 of the reference's
sharded training, the loss falling; host-table steps through ``TrainStep``
equal the unsharded model's within 1e-6; experts the axis does not divide
and a model with no experts raise ``PlanError``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paddlebox_tpu.models import MMoE as FlaxMMoE
from paddlebox_tpu.parallel import expert_shardings as jax_expert_shardings
from paddlebox_tpu.parallel import make_mesh as jax_make_mesh
from paddlebox_tpu_torch.config import TableConfig, TrainerConfig
from paddlebox_tpu_torch.models import DeepFM
from paddlebox_tpu_torch.models.convert import (flax_leaves_from_model,
                                                mmoe_from_flax_leaves)
from paddlebox_tpu_torch.parallel import (AXIS_EP, PlanError,
                                          expert_shardings, make_mesh)
from paddlebox_tpu_torch.parallel.sharding import (ShardedExperts,
                                                   unshard_experts)
from paddlebox_tpu_torch.trainer.train_step import (
    TrainStep, make_dense_optimizer, sigmoid_binary_cross_entropy)

NDEV = 4
KW = dict(num_tasks=2, expert_hidden=(16,), expert_out=8, tower_hidden=(8,))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(B=16, S=3, Dp=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, Dp)).astype(np.float32),
            np.zeros((B, 0), np.float32))


def worlds(experts=8, seed=0, B=16):
    sparse, dense = inputs(B=B, seed=seed)
    model = FlaxMMoE(num_experts=experts, **KW)
    v = model.init(jax.random.PRNGKey(0), jnp.asarray(sparse),
                   jnp.asarray(dense))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(v)]
    port = mmoe_from_flax_leaves(leaves, num_experts=experts, **KW)
    return model, v, port, sparse, dense


def ep_mesh():
    return make_mesh(NDEV, device="cpu", axis_names=(AXIS_EP,))


def test_expert_params_sharded_rest_replicated():
    _, _, port, _, _ = worlds()
    sh = expert_shardings(port, ep_mesh())
    assert isinstance(sh.experts, ShardedExperts)
    assert len(sh.experts.shards) == NDEV
    for s, part in enumerate(sh.experts.shards):
        assert part.kernels[0].shape[0] == 8 // NDEV
        torch.testing.assert_close(
            part.kernels[0], port.experts.kernels[0][2 * s:2 * s + 2],
            rtol=0, atol=0)
    assert sh.expert_specs["experts.kernels.0"] == (AXIS_EP,)
    assert sh.expert_specs["gates.0.weight"] == ()
    # the shards' slices are the module's own parameters, and they join
    # back into the unsharded model
    assert sum(p.numel() for p in sh.parameters()) == \
        sum(p.numel() for p in port.parameters())
    back = unshard_experts(sh)
    for a, b in zip(flax_leaves_from_model(back),
                    flax_leaves_from_model(port)):
        np.testing.assert_array_equal(a, b)


def test_forward_matches_reference():
    model, v, port, sparse, dense = worlds()
    vs = jax.device_put(v, jax_expert_shardings(
        v, jax_make_mesh(NDEV, axis_names=("ep",))))
    want = np.asarray(jax.jit(model.apply)(vs, jnp.asarray(sparse),
                                           jnp.asarray(dense)))
    sh = expert_shardings(port, ep_mesh())
    with torch.no_grad():
        got = sh(torch.from_numpy(sparse), torch.from_numpy(dense)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_train_steps_match_reference():
    model, v, port, sparse, dense = worlds(experts=4, seed=1, B=32)
    labels = (np.random.default_rng(2).uniform(size=(32, 2)) < 0.5
              ).astype(np.float32)
    v = jax.device_put(v, jax_expert_shardings(
        v, jax_make_mesh(NDEV, axis_names=("ep",))))
    opt = optax.adam(1e-2)
    state = opt.init(v)

    @jax.jit
    def step(v, s):
        def loss_fn(v):
            logits = model.apply(v, jnp.asarray(sparse), jnp.asarray(dense))
            return optax.sigmoid_binary_cross_entropy(
                logits, jnp.asarray(labels)).mean()
        loss, g = jax.value_and_grad(loss_fn)(v)
        up, s = opt.update(g, s, v)
        return optax.apply_updates(v, up), s, loss

    sh = expert_shardings(port, ep_mesh())
    dopt = make_dense_optimizer(TrainerConfig(dense_optimizer="adam",
                                              dense_learning_rate=1e-2))
    dstate = dopt.init(sh)
    x, d, y = (torch.from_numpy(a) for a in (sparse, dense, labels))
    losses = []
    for _ in range(8):
        v, state, jloss = step(v, state)
        sh.zero_grad(set_to_none=True)
        loss = sigmoid_binary_cross_entropy(sh(x, d), y).mean()
        loss.backward()
        dopt.update(sh, dstate)
        losses.append(float(loss.detach()))
        np.testing.assert_allclose(losses[-1], float(jloss), rtol=1e-5)
    assert losses[-1] < losses[0]
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(v)]
    for a, b in zip(flax_leaves_from_model(unshard_experts(sh)), want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_host_table_steps_equal_the_unsharded_model():
    """``TrainStep`` over the sharded MMoE against the same step over the
    unsharded one: 2 steps on the same pulled rows."""
    _, _, port, _, _ = worlds()
    B, S, D = 8, 3, 6
    conf = TableConfig(embedx_dim=3, cvm_offset=3)
    rng = np.random.default_rng(3)
    n = 2 * B * S
    segs = np.full(64, B * S, np.int32)
    segs[:n] = np.repeat(np.arange(B * S), 2)
    args = [(rng.normal(size=(64, D)).astype(np.float32), segs,
             np.stack([np.ones(B), np.zeros(B)], 1).astype(np.float32),
             (rng.uniform(size=(B, 2)) < 0.5).astype(np.float32),
             np.zeros((B, 0), np.float32), np.ones(B, np.float32))
            for _ in range(2)]
    outs = []
    for model in (port, expert_shardings(port, ep_mesh())):
        st = TrainStep(model, conf, TrainerConfig(), B, S, device="cpu")
        p, o = st.init()
        auc = st.init_auc_state()
        got = []
        for a in args:
            p, o, auc, demb, loss, preds = st(p, o, auc, *a)
            got.append((demb, float(loss), preds.numpy()))
        outs.append((got, p))
    for (d0, l0, p0), (d1, l1, p1) in zip(outs[0][0], outs[1][0]):
        np.testing.assert_allclose(d1, d0, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(l1, l0, rtol=1e-6)
        np.testing.assert_allclose(p1, p0, rtol=1e-6, atol=1e-7)
    for a, b in zip(flax_leaves_from_model(unshard_experts(outs[1][1])),
                    flax_leaves_from_model(outs[0][1])):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_indivisible_experts_rejected():
    _, _, port, _, _ = worlds(experts=6)
    with pytest.raises(PlanError, match="not divisible"):
        expert_shardings(port, ep_mesh())


def test_no_experts_is_a_dead_rule():
    with pytest.raises(PlanError, match="matched no tensor"):
        expert_shardings(DeepFM(12, (8,)), ep_mesh())
