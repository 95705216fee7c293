"""The serving tier: replica fleet, deadline batching, checkpoint hot
reload, and the host tier above them (counterpart of
``paddlebox_tpu/serving/``).

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

The host tier completes the fault-domain ladder:
:class:`~paddlebox_tpu_torch.serving.host.HostFleet` supervises N spawned
:class:`~paddlebox_tpu_torch.serving.host.ServingHost` process groups (a
front door, a replica fleet and a ``/metrics`` each) and publishes their
endpoints through :mod:`~paddlebox_tpu_torch.serving.resolver`'s
generation-stamped file, which
:class:`~paddlebox_tpu_torch.serving.lb_client.LBClient` reads to balance
requests across the hosts, with the deadline carried through failover and
outlier ejection.

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
    "EndpointResolver": "paddlebox_tpu_torch.serving.resolver",
    "FileResolver": "paddlebox_tpu_torch.serving.resolver",
    "StaticResolver": "paddlebox_tpu_torch.serving.resolver",
    "write_endpoints": "paddlebox_tpu_torch.serving.resolver",
    "HostUnavailable": "paddlebox_tpu_torch.serving.lb_client",
    "LBClient": "paddlebox_tpu_torch.serving.lb_client",
    "HostFleet": "paddlebox_tpu_torch.serving.host",
    "HostSpawnError": "paddlebox_tpu_torch.serving.host",
    "ServingHost": "paddlebox_tpu_torch.serving.host",
}


def __getattr__(name):
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
    "EndpointResolver", "FileResolver", "StaticResolver",
    "write_endpoints", "LBClient", "HostUnavailable",
    "ServingHost", "HostFleet", "HostSpawnError",
]
