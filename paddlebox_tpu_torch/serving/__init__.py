"""The serving tier: replica fleet, deadline batching, checkpoint hot
reload (counterpart of ``paddlebox_tpu/serving/``, its single-host half).

:class:`~paddlebox_tpu_torch.serving.fleet.ReplicaSet` runs N
shared-nothing replicas behind a least-outstanding router with health
probes, supervised restarts and drain on stop;
:class:`~paddlebox_tpu_torch.serving.batcher.DeadlineBatcher` closes
batches on admission deadlines, with SLO-driven load shedding;
:class:`~paddlebox_tpu_torch.serving.reload.ReloadWatcher` swaps the
replicas to each newly committed pass one at a time. With
``scope="process"`` each replica is a spawned child
(:class:`~paddlebox_tpu_torch.serving.proc.ProcReplica`) over the
length-prefixed :mod:`~paddlebox_tpu_torch.serving.transport`, under a
:class:`~paddlebox_tpu_torch.serving.supervisor.RestartSupervisor`;
:class:`~paddlebox_tpu_torch.serving.frontdoor.FrontDoor` gives the fleet
the ``PredictServer`` line protocol. On the card every replica serves
through ``CTRPredictor`` and its seqpool+CVM kernel.

Not ported yet (ROADMAP A.5b): the host tier (``ServingHost``,
``HostFleet``, the endpoint resolvers, ``LBClient``); its names raise
naming it.

``batcher`` and ``transport`` load eagerly and import neither torch nor
numpy; the other modules load at first use.
"""

import importlib

from paddlebox_tpu_torch.serving.batcher import (AdmissionController,
                                                 DeadlineBatcher, Overloaded,
                                                 ReplicaDead, RequestExpired,
                                                 ServingError, SheddingLoad)
from paddlebox_tpu_torch.serving.transport import (TornFrame,
                                                   TransportError,
                                                   WireVersionMismatch)

_LAZY = {
    "NoHealthyReplica": "paddlebox_tpu_torch.serving.fleet",
    "Replica": "paddlebox_tpu_torch.serving.fleet",
    "ReplicaSet": "paddlebox_tpu_torch.serving.fleet",
    "RetryBudgetExhausted": "paddlebox_tpu_torch.serving.fleet",
    "Router": "paddlebox_tpu_torch.serving.fleet",
    "FrontDoor": "paddlebox_tpu_torch.serving.frontdoor",
    "ProcReplica": "paddlebox_tpu_torch.serving.proc",
    "SpawnError": "paddlebox_tpu_torch.serving.proc",
    "ReloadError": "paddlebox_tpu_torch.serving.reload",
    "ReloadWatcher": "paddlebox_tpu_torch.serving.reload",
    "load_predictor_from_plan": "paddlebox_tpu_torch.serving.reload",
    "RestartSupervisor": "paddlebox_tpu_torch.serving.supervisor",
}

#: the reference's host-tier names (``serving/host.py``, ``resolver.py``,
#: ``lb_client.py``), not ported yet
HOST_TIER = ("EndpointResolver", "FileResolver", "StaticResolver",
             "write_endpoints", "HostUnavailable", "LBClient", "HostFleet",
             "HostSpawnError", "ServingHost")


def __getattr__(name):
    if name in HOST_TIER:
        raise NotImplementedError(
            f"{name}: the multi-host serving tier (serving/host.py, "
            "resolver.py, lb_client.py) is not ported yet (ROADMAP A.5b)")
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


__all__ = [
    "AdmissionController", "DeadlineBatcher", "Overloaded", "ReplicaDead",
    "RequestExpired", "ServingError", "SheddingLoad",
    "NoHealthyReplica", "Replica", "ReplicaSet", "RetryBudgetExhausted",
    "Router",
    "FrontDoor", "ProcReplica", "SpawnError", "RestartSupervisor",
    "TornFrame", "TransportError", "WireVersionMismatch",
    "ReloadError", "ReloadWatcher", "load_predictor_from_plan",
]
