"""The port's sharding plan (``paddlebox_tpu_torch/parallel/plan.py``): the
reference's ``tests/test_plan.py`` cases on the port's names (torch's
``.``-joined parameter names where the reference has flax's ``/`` paths),
and its parity matrix: the plan-driven sync-DP engine at 1, 2 and 8 shards
against the reference's single-device ``TrainStep`` on the merged batch
(within the reference test's rtol 2e-4, atol 2e-5)."""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JaxPartitionSpec

from paddlebox_tpu.parallel import Plan as JaxPlan
from paddlebox_tpu.parallel import Rule as JaxRule
from paddlebox_tpu.parallel import make_mesh as jax_make_mesh
from paddlebox_tpu.parallel import \
    match_partition_rules as jax_match_partition_rules
from paddlebox_tpu_torch.config import TrainerConfig
from paddlebox_tpu_torch.parallel import (AXIS_EP, AXIS_MP,
                                          PLAN_SHARDED_AXES, Plan, PlanError,
                                          Rule, make_mesh,
                                          match_partition_rules)
from paddlebox_tpu_torch.parallel.plan import (P, opt_state_tensors,
                                               named_tensors)
from paddlebox_tpu_torch.trainer.train_step import make_dense_optimizer
from torch_dp_worlds import (B, batches, flax_init, leaves_of, port_leaves,
                             port_model, run_port, run_ref_single, tconf)

TREE = {"dense": {"w": np.zeros((8, 4)), "b": np.zeros(4)},
        "head": {"w": np.zeros((4, 1))}}


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8, device="cpu")


# -- rule matching ------------------------------------------------------------

def test_first_match_wins_on_overlap():
    specs = match_partition_rules((Rule(r"dense\.w", P("dp")),
                                   Rule(r".*", P())), TREE)
    assert specs == {"dense.w": P("dp"), "dense.b": P(), "head.w": P()}


def test_rule_order_is_the_precedence():
    with pytest.raises(PlanError, match="matched no tensor"):
        match_partition_rules((Rule(r".*", P()), Rule(r"dense\.w", P("dp"))),
                              TREE)


def test_unspecced_tensor_fails_fast():
    with pytest.raises(PlanError, match="no partition rule matches"):
        match_partition_rules((Rule(r"dense\..*", P()),), TREE)


def test_over_rank_spec_rejected():
    with pytest.raises(PlanError, match="rank-1"):
        match_partition_rules((Rule(r"dense\.b", P(None, "dp")),
                               Rule(r".*", P())), TREE)


def test_mesh_divisibility_checked(mesh8):
    with pytest.raises(PlanError, match="not divisible"):
        match_partition_rules((Rule(r".*", P("dp")),),
                              {"w": np.zeros((6, 4))}, mesh=mesh8)


def test_scalar_leaves_replicate_without_a_rule():
    specs = match_partition_rules((Rule(r"w", P("dp")),),
                                  {"w": np.zeros((8,)), "count": np.zeros(())})
    assert specs == {"w": P("dp"), "count": P()}


def test_scalar_only_tree_needs_no_rules_used():
    assert match_partition_rules((Rule(r".*", P()),),
                                 {"count": np.zeros(())}) == {"count": P()}


@pytest.mark.parametrize("rules,ok", [
    ((("dense/w", "dp"), (".*", None)), True),
    (((".*", None), ("dense/w", "dp")), False),
    ((("dense/.*", None),), False)])
def test_resolution_agrees_with_reference(rules, ok):
    """The same rules (``/`` turned to ``\\.``) resolve alike in both
    packages, or both raise."""
    jrules = [JaxRule(p, JaxPartitionSpec() if a is None
                      else JaxPartitionSpec(a)) for p, a in rules]
    prules = [Rule(p.replace("/", r"\."), P() if a is None else P(a))
              for p, a in rules]
    if not ok:
        with pytest.raises(ValueError):
            jax_match_partition_rules(jrules, TREE)
        with pytest.raises(PlanError):
            match_partition_rules(prules, TREE)
        return
    want = jax_match_partition_rules(jrules, TREE)
    got = match_partition_rules(prules, TREE)
    for path in ("dense/w", "dense/b", "head/w"):
        a, b = path.split("/")
        assert tuple(got[f"{a}.{b}"]) == tuple(want[a][b])


# -- plan validation ----------------------------------------------------------

def test_unknown_data_axis_rejected(mesh8):
    with pytest.raises(PlanError, match="not on the mesh"):
        Plan(mesh=mesh8, data_axis="nope")


def test_rule_axis_off_mesh_rejected(mesh8):
    with pytest.raises(PlanError, match="'mp'"):
        Plan(mesh=mesh8, rules=(Rule(".*", P(AXIS_MP)),))


def test_spec_typo_rejected(mesh8):
    with pytest.raises(PlanError, match="'ddp'"):
        Plan(mesh=mesh8).spec("ddp")


def test_factories_name_their_layouts(mesh8):
    assert Plan.data_parallel(mesh8).name == "dp-dp"
    assert Plan.data_parallel(mesh8, local=True).name == "localsgd-dp"
    assert Plan.zero(mesh8).name == "zero-dp"
    pp = make_mesh(4, device="cpu", axis_names=("pp",))
    assert Plan.pipeline(pp).name == "pipeline-pp"
    assert Plan.expert(make_mesh(4, device="cpu",
                                 axis_names=(AXIS_EP,))).name == "expert-ep"
    assert Plan.data_parallel(mesh8).param_specs(
        {"w": np.zeros((3, 3))}) == {"w": P()}
    assert Plan.zero(mesh8).param_specs(
        {"w": np.zeros((8, 4))}) == {"w": P("dp")}
    assert Plan.data_parallel(mesh8).batch == P("dp")
    assert PLAN_SHARDED_AXES == ("dp", "ep", "pp")


def test_plan_is_hashable(mesh8):
    assert hash(Plan.data_parallel(mesh8)) == hash(Plan.data_parallel(mesh8))
    assert Plan.data_parallel(mesh8) == Plan.data_parallel(mesh8)


def test_reference_factories_resolve_alike():
    """The reference's factories over its mesh and the port's over a CPU
    mesh give the same spec to the same (renamed) tree."""
    tree = {"experts": {"w": np.zeros((4, 3, 2))},
            "my_experts_aux": {"w": np.zeros((3, 2))}}
    jm = jax_make_mesh(4, axis_names=(AXIS_EP,))
    pm = make_mesh(4, device="cpu", axis_names=(AXIS_EP,))
    want = JaxPlan.expert(jm).param_specs(tree)
    got = Plan.expert(pm).param_specs(tree)
    for k in tree:
        assert tuple(got[f"{k}.w"]) == tuple(want[k]["w"])


def test_opt_state_names_cover_the_params():
    model = port_model(flax_init()[1])
    state = make_dense_optimizer(TrainerConfig()).init(model)
    names = opt_state_tensors(model, state)
    assert "count" in names and "mu.mlp.layers.0.weight" in names
    plan = Plan(mesh=make_mesh(2, device="cpu"),
                rules=(Rule(r"layers\.0\.weight", P("dp")), Rule(".*", P())))
    specs = plan.opt_specs(model, state)
    assert specs["count"] == P()
    assert specs["mu.mlp.layers.0.weight"] == P("dp")
    assert specs["nu.bias"] == P()
    assert dict(named_tensors(model)).keys() == \
        plan.param_specs(model).keys()


def test_place_splits_the_sharded_dim():
    plan = Plan.zero(make_mesh(4, device="cpu"))
    t = torch.arange(24.0).reshape(8, 3)
    parts = plan.place(t, P("dp"))
    assert [p.shape for p in parts] == [(2, 3)] * 4
    assert torch.equal(torch.cat(parts), t)
    assert all(torch.equal(p, t) for p in plan.place(t, P()))


# -- the sharding facade (parallel/sharding.py) -------------------------------

def test_expert_scope_matches_whole_path_component():
    plan = Plan.expert(make_mesh(4, device="cpu", axis_names=(AXIS_EP,)))
    specs = plan.param_specs({"experts": {"w": np.zeros((4, 2))},
                              "my_experts_aux": {"w": np.zeros((3, 2))}})
    assert specs == {"experts.w": P(AXIS_EP), "my_experts_aux.w": P()}


def test_no_expert_tensors_is_a_dead_rule():
    plan = Plan.expert(make_mesh(4, device="cpu", axis_names=(AXIS_EP,)))
    with pytest.raises(PlanError, match="matched no tensor"):
        plan.param_specs({"gate": {"w": np.zeros((3, 4))}})


# -- the plan-vs-engine parity matrix -----------------------------------------

@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_matches_oracle_across_mesh_sizes(ndev):
    """One plan-driven sync-DP engine (``ShardedTrainStep`` over
    ``Plan.data_parallel``) at 1, 2 and 8 shards against the reference's
    single-device ``TrainStep`` on the merged batch."""
    jparams, lv = flax_init()
    kws = batches(7, steps=2)
    got, params, *_ = run_port(ndev, kws, tconf(), lv)
    want, wparams, _ = run_ref_single(kws, tconf(ref=True), jparams)
    for a, b in zip(port_leaves(params), leaves_of(wparams)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        np.concatenate([g["preds"] for g in got]),
        np.concatenate([w["preds"].reshape(-1) for w in want]),
        rtol=2e-4, atol=2e-5)
    assert B % ndev == 0

