"""The port's fleet surface (``paddlebox_tpu_torch/parallel/fleet.py``)
against the reference's: role resolution from arguments and environment
over a stub coordinator (the reference's ``tests/test_fleet.py`` cases,
each resolved by both packages), and one spawned world of two processes
that start gloo through ``init_torch_distributed=True`` and ``all_reduce``
a tensor."""

import os
import subprocess
import sys
import textwrap

import pytest

from paddlebox_tpu.parallel import fleet as ref_fleet
from paddlebox_tpu_torch.parallel import fleet
from paddlebox_tpu_torch.parallel.coordinator import local_endpoints

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class StubCoordinator:
    """Records its construction, barriers and close; opens nothing."""

    instances = []

    def __init__(self, rank, endpoints):
        self.rank = rank
        self.endpoints = list(endpoints)
        self.barriers = []
        self.closed = False
        StubCoordinator.instances.append(self)

    def barrier(self, name="b"):
        self.barriers.append(name)

    def close(self):
        self.closed = True


@pytest.fixture(autouse=True)
def clean_fleet(monkeypatch):
    for var in ("PBOX_TRAINER_ID", "PADDLE_TRAINER_ID",
                "PBOX_TRAINER_ENDPOINTS", "PADDLE_TRAINER_ENDPOINTS",
                "PBOX_DIST_ENDPOINT"):
        monkeypatch.delenv(var, raising=False)
    StubCoordinator.instances = []
    for mod in (fleet, ref_fleet):
        monkeypatch.setattr(mod, "Coordinator", StubCoordinator)
        mod._ROLE = None
    yield
    for mod in (fleet, ref_fleet):
        mod._ROLE = None


ENVS = {
    "single_host_default": ({}, {}),
    "paddle_env": ({"PADDLE_TRAINER_ID": "1",
                    "PADDLE_TRAINER_ENDPOINTS":
                        "10.0.0.1:9000,10.0.0.2:9000"}, {}),
    "pbox_env_wins": ({"PADDLE_TRAINER_ID": "1", "PBOX_TRAINER_ID": "2",
                       "PADDLE_TRAINER_ENDPOINTS": "a:1,b:2",
                       "PBOX_TRAINER_ENDPOINTS": "x:1,y:2,z:3"}, {}),
    "explicit_args_win": ({"PBOX_TRAINER_ID": "1",
                           "PBOX_TRAINER_ENDPOINTS": "a:1,b:2"},
                          {"rank": 0, "endpoints": ["only:1"]}),
    "explicit_rank_env_endpoints": ({"PBOX_TRAINER_ENDPOINTS": "a:1,b:2"},
                                    {"rank": 1}),
}


@pytest.mark.parametrize("case", sorted(ENVS))
def test_role_resolution_matches_reference(monkeypatch, case):
    env, args = ENVS[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    roles = []
    for mod in (ref_fleet, fleet):
        StubCoordinator.instances = []
        role = mod.init(**args)
        coord = role.coordinator
        roles.append((role.rank, role.world, role.endpoints,
                      role.is_first_worker(), mod.worker_index(),
                      mod.worker_num(), mod.is_first_worker(),
                      None if coord is None else
                      (coord.rank, coord.endpoints),
                      len(StubCoordinator.instances)))
        mod.barrier("x")
        assert (coord.barriers if coord is not None else []) == \
            (["x"] if role.world > 1 else [])
        mod.stop()
        assert mod._ROLE is None
        assert coord is None or coord.closed
    assert roles[1] == roles[0]
    assert roles[1][8] == (1 if roles[1][1] > 1 else 0)


def test_role_is_lazy_and_single_host_opens_nothing():
    """``role()`` resolves on first use; a world of one starts no
    coordinator and no process group."""
    role = fleet.role()
    assert (role.rank, role.world, role.coordinator,
            role.dist_backend) == (0, 1, None, None)
    assert fleet.role() is role
    assert fleet.init(init_torch_distributed=True).dist_backend is None
    assert not StubCoordinator.instances


def test_store_endpoint_never_takes_the_coordinators_port(monkeypatch):
    eps = ["10.0.0.1:9000", "10.0.0.2:9000"]
    assert fleet.dist_store_endpoint(eps) == "10.0.0.1:9001"
    assert fleet.dist_store_endpoint(eps, "h:5") == "h:5"
    monkeypatch.setenv("PBOX_DIST_ENDPOINT", "s:7")
    assert fleet.dist_store_endpoint(eps) == "s:7"
    assert fleet.dist_store_endpoint(eps, "h:5") == "h:5"


RANK = """
import sys
sys.path.insert(0, {root!r})
import torch
import torch.distributed as dist
from paddlebox_tpu_torch.parallel import fleet
role = fleet.init(init_torch_distributed=True, device="cpu")
assert role.dist_backend == "gloo" and dist.get_backend() == "gloo"
t = torch.full((3,), float(role.rank + 1))
dist.all_reduce(t)
role.coordinator.barrier("done")
peers = role.coordinator.allreduce_sum(__import__("numpy").ones(1))
fleet.stop()
assert not dist.is_initialized()
print("RANK", role.rank, role.world, t.tolist(), float(peers[0]))
"""


def test_spawned_gloo_world_all_reduces(tmp_path):
    """Two spawned processes, each given ``PBOX_TRAINER_ID`` and
    ``PBOX_TRAINER_ENDPOINTS``: ``fleet.init(init_torch_distributed=True,
    device="cpu")`` starts gloo (its store on ``PBOX_DIST_ENDPOINT``), one
    ``all_reduce`` sums the ranks' tensors, the coordinator talks beside
    it, ``stop`` tears both down."""
    eps = local_endpoints(3)
    procs = []
    for rank in range(2):
        env = dict(os.environ, PBOX_TRAINER_ID=str(rank),
                   PBOX_TRAINER_ENDPOINTS=",".join(eps[:2]),
                   PBOX_DIST_ENDPOINT=eps[2])
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(RANK.format(root=ROOT))],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, out in enumerate(outs):
        assert f"RANK {rank} 2 [3.0, 3.0, 3.0] 2.0" in out
