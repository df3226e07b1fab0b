"""Request dispatch across the host pool: which replica of a tenant
gets the next request.

Two pluggable policies (both exclude non-``ACTIVE`` hosts, so a
draining host stops receiving work the step it begins draining):

* :class:`LeastLoaded` — pick the candidate host with the fewest
  pending requests (total across tenants: a host busy with *someone*
  is busy for *everyone* — both processors are shared).  Ties break
  toward the lower host id, keeping dispatch deterministic.
* :class:`ConsistentHash` — a virtual-node hash ring per tenant.
  Requests carrying the same affinity ``key`` land on the same host
  while the pool is stable, and only ~1/N of keys move when a host
  joins or retires — the property that makes elastic scaling cheap
  for cache-warm tenants.

Policies see candidate hosts already filtered to those hosting the
tenant; they only choose among replicas.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Sequence


def _ring_hash(token: str) -> int:
    # stable across processes (unlike hash()) — a ring that reshuffles
    # per run would defeat key affinity
    return int.from_bytes(
        hashlib.blake2b(token.encode(), digest_size=8).digest(), "big"
    )


class LeastLoaded:
    """Route to the candidate with the shortest total queue."""

    name = "least_loaded"

    def choose(self, hosts: Sequence, tenant: str, key=None):
        if not hosts:
            raise LookupError(f"no active host serves tenant {tenant!r}")
        return min(hosts, key=lambda h: (h.pending(), h.host_id))


class ConsistentHash:
    """Key-affinity routing on a virtual-node ring.

    ``replicas`` virtual nodes per host smooth the ring (a plain
    one-node-per-host ring gives some host 3x its share of key
    space).  ``key=None`` falls back to least-loaded — affinity with
    no key is meaningless, and dropping the request on host 0 would
    make keyless tenants a hot spot."""

    name = "consistent_hash"

    def __init__(self, *, replicas: int = 32):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self.replicas = replicas
        self._fallback = LeastLoaded()

    def choose(self, hosts: Sequence, tenant: str, key=None):
        if not hosts:
            raise LookupError(f"no active host serves tenant {tenant!r}")
        if key is None:
            return self._fallback.choose(hosts, tenant)
        ring = []   # (point, host), sorted — rebuilt per call so the
        # ring always reflects the live pool; pools are a handful of
        # hosts, and correctness-under-churn beats caching here
        for h in hosts:
            for r in range(self.replicas):
                ring.append((_ring_hash(f"{h.host_id}:{r}"), h))
        ring.sort(key=lambda p: p[0])
        point = _ring_hash(f"{tenant}:{key}")
        i = bisect.bisect_right([p for p, _ in ring], point)
        return ring[i % len(ring)][1]


POLICIES = {
    LeastLoaded.name: LeastLoaded,
    ConsistentHash.name: ConsistentHash,
}


def make_policy(policy):
    """Resolve a routing policy: an instance passes through, a name
    (``"least_loaded"`` / ``"consistent_hash"``) constructs one."""
    if hasattr(policy, "choose"):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown routing policy {policy!r}; have "
            f"{sorted(POLICIES)}"
        ) from None
