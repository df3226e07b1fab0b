"""Persistent profile/mapping store (``ProfileStore``): ProfileTables
and EfficientConfigurations persisted through a pluggable backend keyed
by (hardware fingerprint, model signature, batch sizes, registry hash,
optional co-tenancy scope), with versioned JSON envelopes, warm start,
and gc/inspect/export.  The port of the JAX package's ``repro.store``;
the fingerprint hashes the torch device, so the two packages' entries
never collide.
"""

from repro_torch.store.profile_store import (
    ProfileStore,
    StoreEntry,
    fleet_scope,
    hardware_fingerprint,
    model_signature,
    registry_hash,
    signature_from_labels,
)

__all__ = [
    "ProfileStore",
    "StoreEntry",
    "fleet_scope",
    "hardware_fingerprint",
    "model_signature",
    "registry_hash",
    "signature_from_labels",
]
