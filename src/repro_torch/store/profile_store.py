"""Persistent profile/mapping store — profile once, adapt forever.

The paper's pipeline re-profiles every platform from scratch on every
run.  :class:`ProfileStore` makes the expensive artifacts — the
:class:`~repro_torch.core.profiler.ProfileTable` a sweep produced and the
:class:`~repro_torch.core.mapper.EfficientConfiguration` the mapper chose —
first-class, persisted, *keyed* documents, so a serving process warm
starts: load the stored mapping, serve immediately, and let the
adaptive runtime (``repro_torch.adapt``) correct it online.  The
``RemapController`` writes its remapped *configurations* back, so the
next process warm-starts from the adapted mapping.  Corrected tables
are deliberately **not** persisted: they encode observed — possibly
transient — conditions, and a placement the remap abandoned can never
be re-observed to recover, so the factory profile on disk stays
authoritative (one contention episode must not poison warm starts
forever).

**Key.**  An artifact is valid only for the platform, model, batch
sizes and kernel space it was measured under, so entries are keyed by

* ``hardware_fingerprint(device)`` — host platform/processor/core-count
  plus the torch device the tables are measured on (``"cuda"`` with the
  card's name and compute capability, or ``"cpu"``): a profile from
  machine A must never warm-start machine B, and the fields differ from
  the JAX package's (JAX backend and device kind), so an entry written
  by one package is never read by the other;
* ``model_signature(model)`` — model name + the per-layer labels the
  profiler emits (a resized or re-architected model re-profiles);
* the profiled ``batch_sizes`` (profiles) / serving batch (mappings);
* ``registry_hash()`` — the kernel-variant registry's names and
  pricing metadata (registering a new variant invalidates nothing, it
  just keys new entries; *changing* a variant's semantics re-keys);
* optionally a **scope** — a namespace for artifacts that are only
  valid under a particular co-tenancy: a fleet's jointly-mapped
  configurations are optimal only against that fleet's co-runners, so
  they live under ``fleet_scope(names)`` and a solo warm start can
  never pick one up (nor vice versa).

**Backends.**  The store reads and writes through a pluggable
:class:`~repro_torch.cachesvc.backends.StoreBackend` (``root`` accepts a
path, a ``dir://`` / ``sqlite://`` / ``mem://`` URI, or a backend
instance — see ``repro_torch.cachesvc``).  The entry *key* is the
relative POSIX path of the layout below, identical across backends and
across the two packages, so a ``dir://`` root holds the same files
whichever package wrote it.  Serving-path loads go through
``backend.get`` — the hit/miss/access counters they feed are the
cache service's prewarm popularity signal; maintenance reads
(``entries``/``gc``/``export``) use counter-silent peeks.

**Layout.**  ``root/v<schema>/<fingerprint>/<model>-r<registry>/`` with
one JSON document per artifact (``profile-b<sizes>.json``,
``mapping-<policy>-b<batch>.json``), each wrapped in a versioned
envelope (schema, kind, saved_at, full key) around the payload's own
versioned JSON (``ProfileTable.to_json`` /
``EfficientConfiguration.to_json``).  Loaders verify the envelope key
before trusting a payload; unknown newer schemas are refused, not
misread.  :meth:`ProfileStore.entries` / :meth:`~ProfileStore.stats` /
:meth:`~ProfileStore.gc` / :meth:`~ProfileStore.export` inspect and
maintain the same layout on any backend.

**Training rows.**  Every profile run additionally appends estimator
training rows (``repro_torch.estimator.features``) under
``training-r<registry>/rows-*.json`` — same envelope, additive kind
``training_rows`` — so :class:`~repro_torch.estimator.LatencyPredictor`
accumulates cross-model, cross-run data per (fingerprint, registry,
scope) key (:meth:`ProfileStore.predictor`).  A *fitted* predictor and a
calibrated interference law can be persisted beside the rows
(:meth:`save_predictor` / :meth:`save_interference`) so the cache
service's ``refit`` worker re-trains only when enough new rows
accumulated since the last fit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import time
from pathlib import Path
from typing import Callable, Sequence

import torch

from repro_torch.cachesvc.backends import parse_backend
from repro_torch.core.mapper import EfficientConfiguration
from repro_torch.core.profiler import ProfileTable
from repro_torch.device import resolve_device

SCHEMA_VERSION = 1


def _digest(parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(repr(p).encode())
        h.update(b"\x00")
    return h.hexdigest()[:12]


def hardware_fingerprint(device=None) -> str:
    """Short stable hash of the serving platform: host CPU identity and
    core count plus the torch device the tables are measured on
    (``device`` as :func:`~repro_torch.device.resolve_device` takes it:
    ``None`` -> ``cuda``).  A CUDA device contributes ``"cuda"``, its
    name and its compute capability; the CPU contributes ``"cpu"``.
    Deliberately excludes load/clock state — that is what telemetry
    tracks."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        ident = (
            "cuda",
            torch.cuda.get_device_name(dev),
            tuple(torch.cuda.get_device_capability(dev)),
        )
    else:
        ident = (dev.type,)
    return _digest(
        (
            platform.system(),
            platform.machine(),
            platform.processor(),
            os.cpu_count(),
        )
        + ident
    )


def model_signature(model) -> str:
    """Hash of the model's name + per-layer labels — exactly the labels
    a ProfileTable for it carries, so table and model key identically."""
    labels = tuple(f"L{s.idx}:{s.notation}" for s in model.specs)
    return signature_from_labels(model.name, labels)


def signature_from_labels(model_name: str, layer_labels) -> str:
    return _digest((model_name,) + tuple(layer_labels))


def registry_hash(registry=None) -> str:
    """Hash of the kernel-variant space: every registered name with its
    scope, placement and pricing metadata, order-independent.  The
    scope is part of the row, so a registry with segment-scope (fused)
    variants keys different entries than a per-layer-only one — fused
    and per-layer stores never cross-contaminate."""
    if registry is None:
        from repro_torch.kernels.registry import DEFAULT_REGISTRY

        registry = DEFAULT_REGISTRY
    rows = sorted(
        (
            v.name,
            getattr(v, "scope", "layer"),
            v.placement,
            tuple(v.aspects),
            v.p_blk,
            v.n_blk,
            v.analytic,
        )
        for v in registry
    )
    return _digest(rows)


def _batch_key(batch_sizes: Sequence[int]) -> str:
    # canonicalized: (4, 1) and (1, 4) are the same profiled set
    return "x".join(str(int(b)) for b in sorted(batch_sizes))


def fleet_scope(tenant_names: Sequence[str]) -> str:
    """The store scope for a fleet's artifacts, canonicalized over the
    tenant composition (order-insensitive, duplicates collapse): the
    same models co-served in any order share warm starts, a different
    mix re-keys — a mapping jointly optimized against one set of
    co-runners must never warm-start another."""
    names = sorted(set(tenant_names))
    if not names:
        raise ValueError("fleet_scope needs at least one tenant name")
    return "fleet-" + _digest(names)


@dataclasses.dataclass(frozen=True)
class StoreEntry:
    """One stored artifact, as ``inspect`` reports it.  ``store_key``
    is the backend key (the relative path on a dir backend); ``path``
    is where that key lives — real on a dir backend, synthesized under
    the display root elsewhere."""

    path: Path
    kind: str
    schema: int
    saved_at: float
    key: dict
    size_bytes: int
    store_key: str = ""

    @property
    def age_s(self) -> float:
        return max(0.0, time.time() - self.saved_at)


class ProfileStore:
    def __init__(
        self,
        root,
        *,
        fingerprint: str | None = None,
        registry=None,
        scope: str | None = None,
        device=None,
    ):
        """``root`` is a directory path (today's layout), a backend URI
        (``dir://`` / ``sqlite://`` / ``mem://``), or a
        :class:`~repro_torch.cachesvc.backends.StoreBackend` instance —
        handles constructed over the same backend share one cache.

        ``scope`` namespaces every artifact this handle reads or
        writes (module docstring): a scoped store neither sees
        scope-less entries nor leaks into them — fleets pass
        :func:`fleet_scope` so per-co-tenancy mappings and solo
        mappings of the same model coexist under one root.

        ``device`` is the torch device whose fingerprint keys this
        handle when no explicit ``fingerprint`` is given (``None`` ->
        ``cuda``; pass ``"cpu"`` for tables measured on the CPU)."""
        if scope is not None and (
            not scope or any(c in scope for c in "/\\\0")
        ):
            raise ValueError(
                "scope must be a non-empty path-component-safe string"
            )
        self.backend = parse_backend(root)
        base = self.backend.path_for("")
        if base is not None:
            self.root = base
        else:
            # display root only — non-dir backends have no real files,
            # but entries()/export() still report per-key paths under it
            self.root = Path(
                str(getattr(self.backend, "path", "") or self.backend.uri())
            )
        self.scope = scope
        self._device = device
        self._fingerprint = fingerprint
        self._registry = registry
        self._registry_hash: str | None = None

    def with_scope(self, scope: str | None) -> "ProfileStore":
        """A handle over the *same backend* (shared counters, shared
        cache) under a different scope."""
        return ProfileStore(
            self.backend,
            fingerprint=self._fingerprint,
            registry=self._registry,
            scope=scope,
            device=self._device,
        )

    def stats(self) -> dict:
        """The backend's counters (hits/misses/puts/evictions)."""
        return self.backend.stats()

    # -- keys --------------------------------------------------------
    @property
    def fingerprint(self) -> str:
        if self._fingerprint is None:
            self._fingerprint = hardware_fingerprint(self._device)
        return self._fingerprint

    @property
    def space_hash(self) -> str:
        if self._registry_hash is None:
            self._registry_hash = registry_hash(self._registry)
        return self._registry_hash

    def _base_key(self) -> str:
        parts = [f"v{SCHEMA_VERSION}", self.fingerprint]
        if self.scope is not None:
            parts.append(f"s-{self.scope}")
        return "/".join(parts)

    def _dir_key(self, model_sig: str) -> str:
        return f"{self._base_key()}/{model_sig}-r{self.space_hash}"

    def profile_key(self, model_sig: str, batch_sizes) -> str:
        return (
            f"{self._dir_key(model_sig)}"
            f"/profile-b{_batch_key(batch_sizes)}.json"
        )

    def mapping_key(self, model_sig: str, policy: str, batch: int) -> str:
        return (
            f"{self._dir_key(model_sig)}/mapping-{policy}-b{int(batch)}.json"
        )

    def _path_of(self, key: str) -> Path:
        p = self.backend.path_for(key)
        return p if p is not None else self.root / key

    def _dir(self, model_sig: str) -> Path:
        return self._path_of(self._dir_key(model_sig))

    def profile_path(self, model_sig: str, batch_sizes) -> Path:
        return self._path_of(self.profile_key(model_sig, batch_sizes))

    def mapping_path(self, model_sig: str, policy: str, batch: int) -> Path:
        return self._path_of(self.mapping_key(model_sig, policy, batch))

    # -- envelope ----------------------------------------------------
    def _envelope(self, kind: str, key: dict, payload: dict) -> str:
        return json.dumps(
            {
                "schema": SCHEMA_VERSION,
                "kind": kind,
                "saved_at": time.time(),
                "key": {
                    "fingerprint": self.fingerprint,
                    "registry": self.space_hash,
                    **({"scope": self.scope}
                       if self.scope is not None else {}),
                    **key,
                },
                "payload": payload,
            },
            indent=2,
        )

    def _open(self, store_key: str, kind: str) -> dict | None:
        """Read + verify an envelope; None when absent or keyed for a
        different platform/registry (never served cross-key).  Goes
        through ``backend.get`` so serving-path loads feed the cache
        counters (the prewarm popularity signal)."""
        text = self.backend.get(store_key)
        if text is None:
            return None
        doc = json.loads(text)
        if doc.get("schema", 0) > SCHEMA_VERSION:
            raise ValueError(
                f"{store_key}: store schema {doc.get('schema')} is newer "
                f"than supported ({SCHEMA_VERSION}); upgrade the loader"
            )
        if doc.get("kind") != kind:
            return None
        key = doc.get("key", {})
        if key.get("fingerprint") != self.fingerprint:
            return None
        if key.get("registry") != self.space_hash:
            return None
        # symmetric scope check: a scoped handle refuses scope-less
        # entries and vice versa (key.get returns None for both sides)
        if key.get("scope") != self.scope:
            return None
        return doc

    def _put(self, store_key: str, doc: str) -> Path:
        self.backend.put(store_key, doc)
        return self._path_of(store_key)

    # -- profiles ----------------------------------------------------
    def save_profile(self, table: ProfileTable) -> Path:
        sig = signature_from_labels(table.model_name, table.layer_labels)
        spans = sorted(
            {
                span
                for rows in (table.segment_times or {}).values()
                for span in rows
            }
        )
        doc = self._envelope(
            "profile_table",
            {
                "model": sig,
                "model_name": table.model_name,
                "batch_sizes": list(table.batch_sizes),
                # spans with fused segment-variant rows (informational,
                # for `inspect` — () on per-layer-only tables)
                "segment_spans": spans,
            },
            json.loads(table.to_json()),
        )
        return self._put(self.profile_key(sig, table.batch_sizes), doc)

    def load_profile(
        self, model, batch_sizes: Sequence[int]
    ) -> ProfileTable | None:
        sig = model_signature(model)
        doc = self._open(
            self.profile_key(sig, batch_sizes), "profile_table"
        )
        if doc is None:
            return None
        return ProfileTable.from_json(json.dumps(doc["payload"]))

    def get_or_profile(
        self,
        model,
        packed_params,
        profile_fn: Callable,
        *,
        batch_sizes: Sequence[int],
    ) -> tuple:
        """(table, loaded): the stored profile when one matches the
        key, else ``profile_fn(model, packed_params,
        batch_sizes=batch_sizes)`` — run, saved, and returned.  The
        warm-start contract: a hit performs **zero** profiling."""
        table = self.load_profile(model, batch_sizes)
        if table is not None:
            return table, True
        table = profile_fn(model, packed_params, batch_sizes=batch_sizes)
        self.save_profile(table)
        self._record_training_rows(model, table)
        return table, False

    # -- estimator training data -------------------------------------
    def _training_key(self) -> str:
        return f"{self._base_key()}/training-r{self.space_hash}"

    def training_dir(self) -> Path:
        """Training rows live beside the per-model dirs, keyed by the
        same (fingerprint, registry, scope) — rows measured under one
        kernel space or platform never train a predictor for
        another."""
        return self._path_of(self._training_key())

    def _record_training_rows(self, model, table) -> None:
        """Every real profile run feeds the estimator's training set —
        best-effort: extraction failure must never fail the profiling
        path that produced the table."""
        try:
            from repro_torch.estimator.features import training_rows_from_table

            rows = training_rows_from_table(
                model, table, registry=self._registry
            )
            if rows:
                # keyed by signature + batch sweep, not model name:
                # width variants of one family share a name, and each
                # sweep's rows must accumulate, not overwrite
                sig = signature_from_labels(
                    table.model_name, table.layer_labels
                )
                self.save_training_rows(
                    rows,
                    source=(
                        f"profile:{sig}"
                        f"-b{_batch_key(table.batch_sizes)}"
                    ),
                )
        except Exception:
            pass

    def save_training_rows(self, rows, *, source: str | None = None) -> Path:
        """Persist one batch of estimator training rows
        (``repro_torch.estimator.features.training_rows_from_table``) as a
        keyed envelope.  One document per (models, batches) source;
        re-profiling the same sweep overwrites rather than
        duplicates."""
        rows = list(rows)
        if not rows:
            raise ValueError("no training rows to save")
        models = sorted({r.get("model", "?") for r in rows})
        if source is None:
            source = _digest(
                sorted(
                    (r.get("model", "?"), r.get("batch", 0))
                    for r in rows
                )
            )
        doc = self._envelope(
            "training_rows",
            {
                "source": source,
                "models": models,
                "n_rows": len(rows),
            },
            {"rows": rows},
        )
        return self._put(
            f"{self._training_key()}/rows-{_digest([source])}.json", doc
        )

    def load_training_rows(self) -> list:
        """Every training row stored under this handle's key, across
        all saved batches — the estimator's training set."""
        rows: list = []
        prefix = self._training_key() + "/"
        for store_key in self.backend.list(prefix):
            name = store_key[len(prefix):]
            if not (name.startswith("rows-") and name.endswith(".json")):
                continue
            doc = self._open(store_key, "training_rows")
            if doc is None:
                continue
            rows.extend(doc["payload"].get("rows", ()))
        return rows

    def predictor(self, **kwargs):
        """A :class:`~repro_torch.estimator.LatencyPredictor` fitted on the
        accumulated training rows, or ``None`` when the store has no
        rows yet — callers fall back to a real profiling pass (and
        thereby create the first rows)."""
        from repro_torch.estimator.latency import LatencyPredictor

        rows = self.load_training_rows()
        if not rows:
            return None
        return LatencyPredictor(**kwargs).fit(rows)

    # -- fitted estimator artifacts (cachesvc refit worker) ----------
    def _predictor_key(self) -> str:
        return f"{self._training_key()}/latency-predictor.json"

    def save_predictor(self, predictor, *, source_rows: int) -> Path:
        """Persist a *fitted* predictor with the training-set size it
        was fitted on, so the refit worker can tell when enough new
        rows accumulated to justify retraining."""
        doc = self._envelope(
            "latency_predictor",
            {
                "n_rows": int(getattr(predictor, "n_rows", 0)),
                "source_rows": int(source_rows),
            },
            json.loads(predictor.to_json()),
        )
        return self._put(self._predictor_key(), doc)

    def load_predictor(self):
        """The persisted fitted predictor, or None."""
        from repro_torch.estimator.latency import LatencyPredictor

        doc = self._open(self._predictor_key(), "latency_predictor")
        if doc is None:
            return None
        return LatencyPredictor.from_json(json.dumps(doc["payload"]))

    def predictor_meta(self) -> dict | None:
        """{'n_rows', 'source_rows', 'saved_at'} of the persisted
        predictor (counter-silent), or None when never fitted."""
        text = self.backend.peek(self._predictor_key())
        if text is None:
            return None
        doc = json.loads(text)
        if doc.get("kind") != "latency_predictor":
            return None
        key = doc.get("key", {})
        return {
            "n_rows": int(key.get("n_rows", 0)),
            "source_rows": int(key.get("source_rows", 0)),
            "saved_at": float(doc.get("saved_at", 0.0)),
        }

    def _interference_key(self) -> str:
        return f"{self._training_key()}/interference-law.json"

    def save_interference(self, law) -> Path:
        """Persist a calibrated contention law
        (:class:`~repro_torch.estimator.interference.FittedInterference`)."""
        doc = self._envelope(
            "interference_law",
            {"n_obs": int(getattr(law, "n_obs", 0))},
            json.loads(law.to_json()),
        )
        return self._put(self._interference_key(), doc)

    def load_interference(self):
        """The persisted contention law, or None."""
        from repro_torch.estimator.interference import FittedInterference

        doc = self._open(self._interference_key(), "interference_law")
        if doc is None:
            return None
        return FittedInterference.from_json(json.dumps(doc["payload"]))

    # -- mappings ----------------------------------------------------
    def save_mapping(self, config: EfficientConfiguration) -> Path:
        sig = signature_from_labels(config.model_name, config.layer_labels)
        fused = getattr(config, "fused_segments", ())
        doc = self._envelope(
            "efficient_configuration",
            {
                "model": sig,
                "model_name": config.model_name,
                "batch": config.proper_batch_size,
                "policy": config.policy,
                # surfaced (not verified) so `inspect` can tell fused
                # and per-layer mappings apart without parsing payloads
                "fused_variants": sorted(
                    {name for _, _, name, _ in fused}
                ),
            },
            json.loads(config.to_json()),
        )
        return self._put(
            self.mapping_key(
                sig, config.policy, config.proper_batch_size
            ),
            doc,
        )

    def load_mapping(
        self, model, *, policy: str = "dp", batch: int | None = None
    ) -> EfficientConfiguration | None:
        """The stored mapping for (platform, model, registry) —
        at `batch` when given, else the most recently saved one for
        `policy`."""
        return self.load_mapping_for_labels(
            model_signature(model), policy=policy, batch=batch
        )

    def load_mapping_for_labels(
        self,
        model_sig: str,
        *,
        policy: str = "dp",
        batch: int | None = None,
    ) -> EfficientConfiguration | None:
        """:meth:`load_mapping` by precomputed signature
        (:func:`signature_from_labels`) — for callers that hold a
        table/configuration but no model object."""
        sig = model_sig
        if batch is not None:
            keys = [self.mapping_key(sig, policy, batch)]
        else:
            prefix = self._dir_key(sig) + "/"
            stem = f"mapping-{policy}-b"
            keys = [
                k for k in self.backend.list(prefix)
                if k[len(prefix):].startswith(stem)
                and k.endswith(".json")
            ]
        best = None
        for store_key in keys:
            doc = self._open(store_key, "efficient_configuration")
            if doc is None:
                continue
            if best is None or doc.get("saved_at", 0.0) > best.get(
                "saved_at", 0.0
            ):
                best = doc
        if best is None:
            return None
        return EfficientConfiguration.from_json(
            json.dumps(best["payload"])
        )

    def warm_start(
        self,
        model,
        *,
        batch_sizes: Sequence[int],
        policy: str = "dp",
    ) -> tuple | None:
        """(table, config) for an immediate serve with no profiling
        pass, or None when this platform has no stored profile.  A
        missing mapping is re-derived from the stored table (cheap —
        the sweep, not the solve, is what the store amortizes)."""
        from repro_torch.core.mapper import map_efficient_configuration

        table = self.load_profile(model, batch_sizes)
        if table is None:
            return None
        config = self.load_mapping(model, policy=policy)
        if (
            config is None
            or config.layer_labels != table.layer_labels
            # a mapping remapped/saved at a batch this sweep never
            # profiled cannot be served against this table
            or config.proper_batch_size not in table.batch_sizes
        ):
            config = map_efficient_configuration(table, policy=policy)
            self.save_mapping(config)
        return table, config

    # -- maintenance ---------------------------------------------------
    def entries(self) -> list:
        """Every parseable artifact in the backend, newest first —
        including other schemas/fingerprints (inspect sees all).
        Counter-silent: maintenance must not skew popularity."""
        out = []
        for store_key in self.backend.list():
            text = self.backend.peek(store_key)
            if text is None:
                continue
            try:
                doc = json.loads(text)
            except json.JSONDecodeError:
                continue
            if not isinstance(doc, dict) or "kind" not in doc:
                continue
            out.append(
                StoreEntry(
                    path=self._path_of(store_key),
                    kind=doc.get("kind", "?"),
                    schema=int(doc.get("schema", 0)),
                    saved_at=float(doc.get("saved_at", 0.0)),
                    key=doc.get("key", {}),
                    size_bytes=len(text.encode()),
                    store_key=store_key,
                )
            )
        out.sort(key=lambda e: e.saved_at, reverse=True)
        return out

    def gc(
        self, *, max_age_s: float | None = None, dry_run: bool = False
    ) -> list:
        """Remove stale artifacts: anything from an older store schema,
        plus (when ``max_age_s`` is set) current-schema entries older
        than that.  Returns the removed paths; empty directories are
        pruned (dir backends)."""
        removed = []
        for entry in self.entries():
            stale = entry.schema < SCHEMA_VERSION or (
                max_age_s is not None and entry.age_s > max_age_s
            )
            if not stale:
                continue
            removed.append(entry.path)
            if not dry_run:
                self.backend.delete(entry.store_key)
        if not dry_run:
            prune = getattr(self.backend, "prune_empty_dirs", None)
            if prune is not None:
                prune()
        return removed

    def export(self) -> dict:
        """One self-contained bundle of every artifact (portable
        backup; re-import by writing the files back)."""
        return {
            "schema": SCHEMA_VERSION,
            "kind": "profile_store_export",
            "exported_at": time.time(),
            "entries": [
                {
                    "path": e.store_key,
                    "document": json.loads(
                        self.backend.peek(e.store_key)
                    ),
                }
                for e in self.entries()
            ],
        }
