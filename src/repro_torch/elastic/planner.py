"""Per-level planning for a subnet family: profile (or predict), map,
fuse, persist — K resident mappings from one pass.

Each :class:`~repro_torch.elastic.subnet.SubnetLevel` is an ordinary
``BNNModel`` + packed params, so it flows through the exact
profile→map(→fuse) chain every other model uses
(:func:`repro_torch.api.plan_single`).  What this module adds:

* **level-tagged persistence** — narrow levels are named
  ``{base}#L{k}`` so their profiles and mappings land under distinct
  :class:`~repro_torch.store.ProfileStore` keys; all K mappings warm-start
  independently and are resident simultaneously;
* **zero-sweep narrow levels** — with ``estimate=True`` and a store
  that holds a fitted :class:`~repro_torch.estimator.LatencyPredictor`, the
  narrow levels' tables are *predicted* (``provenance="predicted"``,
  zero profiling passes) and only mapped+persisted; level 0 is always
  real (it is the model you already profiled);
* **swap compatibility** — every level must resolve to the same
  proper batch size (the serving engine hot-swaps configurations at
  batch boundaries and refuses a batch-size change mid-flight); the
  planner enforces this up front.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.elastic.subnet import SubnetFamily


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """One :class:`~repro_torch.api.TenantPlan` per subnet level, widest
    first.  ``predicted[k]`` records whether level k's table came from
    the latency predictor (True) or a real profiling sweep."""

    family: SubnetFamily
    levels: tuple            # TenantPlan per level, widest first
    predicted: tuple         # bool per level

    @property
    def base(self):
        return self.levels[0]

    @property
    def configs(self) -> tuple:
        """Per-level EfficientConfigurations, widest first — what an
        elastic engine holds resident."""
        return tuple(tp.config for tp in self.levels)

    @property
    def batch(self) -> int:
        return self.levels[0].config.proper_batch_size

    def __len__(self) -> int:
        return len(self.levels)


def _predict_level(level, store, *, batch_sizes, registry, configs):
    """Predicted ProfileTable for a narrow level, or None when the
    store holds no fitted predictor."""
    if store is None:
        return None
    predictor = store.load_predictor()
    if predictor is None:
        return None
    return predictor.predict_table(
        level.model, batch_sizes, registry=registry, configs=configs
    )


def plan_family(
    family: SubnetFamily,
    *,
    base=None,
    batch_sizes: Sequence[int] = (4,),
    store=None,
    policy: str = "dp",
    configs: Sequence[str] | None = None,
    autotune: bool = False,
    fuse: bool = False,
    repeats: int = 2,
    time_source: str = "measured",
    registry=None,
    estimate: bool = False,
    device=None,
) -> ElasticPlan:
    """Plan every level of `family`; returns an :class:`ElasticPlan`.

    `base` is an already-planned :class:`~repro_torch.api.TenantPlan` for
    the full model (level 0) — pass it to reuse the profile/mapping a
    solo or fleet plan already produced (the elastic serve path does
    this so level 0 keeps its joint contention-priced config); its
    batch sizes override `batch_sizes` so narrow levels price the
    batches the engine will actually run.  ``estimate=True`` prices
    narrow levels through the store's persisted latency predictor
    when one exists (zero extra sweeps), silently falling back to
    real profiling when the store has never been ``refit``.
    Measured profiles run on `device` (``None`` -> ``cuda``), which
    also keys a store given as a root or URI.
    """
    from repro_torch.api import TenantPlan, _as_store, map_model, plan_single

    store = _as_store(store, device=device)
    if base is not None:
        if base.model is not family.base.model:
            raise ValueError(
                "base TenantPlan was built for a different model than "
                "family level 0"
            )
        batch_sizes = tuple(base.table.batch_sizes)
    levels: list = []
    predicted: list = []
    for lvl in family:
        if lvl.level == 0 and base is not None:
            levels.append(base)
            predicted.append(False)
            continue
        table = None
        if estimate and lvl.level > 0:
            table = _predict_level(
                lvl, store, batch_sizes=batch_sizes,
                registry=registry, configs=configs,
            )
        if table is not None:
            config = map_model(table, policy=policy, configs=configs)
            if store is not None:
                # persist the mapping only: predicted tables must not
                # masquerade as measured profiles under the store key
                store.save_mapping(config)
            levels.append(
                TenantPlan(
                    name=lvl.model.name, model=lvl.model,
                    packed=lvl.packed, table=table, config=config,
                )
            )
            predicted.append(True)
        else:
            levels.append(
                plan_single(
                    lvl.model, lvl.packed, batch_sizes=batch_sizes,
                    store=store, policy=policy, configs=configs,
                    autotune=autotune, fuse=fuse, repeats=repeats,
                    time_source=time_source, registry=registry,
                    name=lvl.model.name, device=device,
                )
            )
            predicted.append(False)
    batches = {tp.config.proper_batch_size for tp in levels}
    if len(batches) != 1:
        raise ValueError(
            f"subnet levels resolved to different proper batch sizes "
            f"{sorted(batches)}; hot swaps require one — pass a single "
            "batch in batch_sizes"
        )
    return ElasticPlan(
        family=family, levels=tuple(levels), predicted=tuple(predicted)
    )
