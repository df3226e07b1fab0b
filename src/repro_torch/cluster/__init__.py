"""Multi-host cluster serving tier.

Scales the single-host co-serving stack (``repro_torch.fleet``) out to
a pool of logical hosts: contention-priced tenant placement
(:mod:`~repro_torch.cluster.placement`), per-host routers and ledgers
(:mod:`~repro_torch.cluster.host`), pluggable request dispatch
(:mod:`~repro_torch.cluster.dispatch`), and an elastic pool controller
with a journaled decision trail (:mod:`~repro_torch.cluster.elastic`).

A host is an in-process object, as in the JAX package: the hosts of
one process share its one CPU and its one card, so the placement's
"no cross-host contention" is a model of separate machines, not what
the hosts of one process see.

Most consumers should reach this through
``repro_torch.api.Deployment.plan(models, hosts=N)`` rather than
constructing a :class:`Cluster` directly.
"""

from repro_torch.cluster.cluster import Cluster
from repro_torch.cluster.dispatch import (
    ConsistentHash,
    LeastLoaded,
    make_policy,
)
from repro_torch.cluster.elastic import (
    ElasticController,
    ScaleRecord,
    remesh_state,
)
from repro_torch.cluster.host import (
    ACTIVE,
    DRAINING,
    RETIRED,
    ServingHost,
    latency_quantile,
)
from repro_torch.cluster.placement import (
    ClusterPlan,
    HostAssignment,
    place_tenants,
)

__all__ = [
    "ACTIVE",
    "DRAINING",
    "RETIRED",
    "Cluster",
    "ClusterPlan",
    "ConsistentHash",
    "ElasticController",
    "HostAssignment",
    "LeastLoaded",
    "ScaleRecord",
    "ServingHost",
    "latency_quantile",
    "make_policy",
    "place_tenants",
    "remesh_state",
]
