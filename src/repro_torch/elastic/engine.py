"""An elastic serving engine: K nested-width subnets resident behind
one ``submit()``/``step()`` front end, switchable at batch boundaries.

:class:`ElasticEngine` extends :class:`~repro_torch.serving.ServingEngine`
with a *level* axis orthogonal to the existing configuration hot swap:
each level is a (model, packed, configuration) triple from an
:class:`~repro_torch.elastic.planner.ElasticPlan`, built pipelines are
cached per level, and :meth:`set_level` republishes
``model``/``packed_params``/``config``/``pipeline`` together — with
the same batch-boundary atomicity as ``swap_configuration`` (a switch
requested mid-step is deferred to the end of the in-flight
wave-train; the incoming level's pipeline is built *before* the
outgoing one is released).  Every level's packed params are moved to
the engine's device once, at construction, so a level switch copies no
weight; narrower levels are prefix slices of the base tensors (views
where the prefix is contiguous, copies where it is strided — see
:mod:`repro_torch.elastic.subnet`), so K resident levels cost one
model's weights, the strided levels' copies and K built pipelines.

``quality_floor`` is the deepest level index the engine may ever
serve (0 pins full width).  It is enforced *here*, at the actuator —
the :class:`~repro_torch.fleet.router.QualityController` respects it when
choosing transitions, but a bug above this line still cannot push a
tenant below its floor.

``swap_configuration`` stays fully functional and is *routed by model
name*: the cluster's joint remap hands a level-0 configuration, the
adaptive controller may hand one for whatever level telemetry was
watching — each lands on its level's slot (invalidating that level's
cached pipeline) and only touches the live pipeline when that level
is the one currently serving.
"""

from __future__ import annotations

from repro_torch.bnn.models import params_to
from repro_torch.device import resolve_device
from repro_torch.elastic.planner import ElasticPlan
from repro_torch.serving.engine import ServingEngine


class ElasticEngine(ServingEngine):
    def __init__(
        self,
        plan: ElasticPlan,
        *,
        config=None,
        quality_floor: int | None = None,
        device=None,
        **kwargs,
    ):
        """`plan` carries the per-level models/params/configurations.
        `config` overrides level 0's configuration (the cluster tier
        passes the joint contention-priced mapping here; solo serving
        leaves it as planned).  `quality_floor` is the deepest
        permitted level (default: the narrowest level in the plan).
        Every level is served on `device` (``None`` -> ``cuda``), where
        its packed params are made resident here.  Remaining kwargs
        are the :class:`ServingEngine` knobs."""
        if len(plan) < 2:
            raise ValueError(
                "an elastic engine needs at least two subnet levels; "
                "use ServingEngine for a fixed model"
            )
        self.plan = plan
        self._level_configs = list(plan.configs)
        if config is not None:
            self._level_configs[0] = config
        batches = {c.proper_batch_size for c in self._level_configs}
        if len(batches) != 1:
            raise ValueError(
                f"level configurations disagree on proper batch size "
                f"{sorted(batches)}; level switches swap at batch "
                "boundaries and cannot re-batch"
            )
        floor = len(plan) - 1 if quality_floor is None else int(quality_floor)
        if not 0 <= floor < len(plan):
            raise ValueError(
                f"quality_floor {floor} outside levels "
                f"[0, {len(plan) - 1}]"
            )
        self.quality_floor = floor
        self.level = 0
        self.level_switches = 0
        self.degraded_steps = 0      # non-empty steps served below full width
        self._pending_level: int | None = None
        self._pipelines: dict = {}   # level -> built SegmentPipeline
        dev = resolve_device(device)
        # level -> packed params resident on the engine's device
        self._packed = [
            [params_to(p, dev) for p in tp.packed] for tp in plan.levels
        ]
        base = plan.levels[0]
        # ServingEngine.__init__ builds level 0's pipeline through
        # _build_pipeline — the subclass seam taxed/instrumented
        # engines override — so every attribute it could touch is set
        # above, before this call
        super().__init__(
            base.model, self._packed[0], self._level_configs[0],
            device=dev, **kwargs,
        )
        self._pipelines[0] = self.pipeline

    # -- level plumbing ---------------------------------------------
    @property
    def n_levels(self) -> int:
        return len(self.plan)

    @property
    def degraded_share(self) -> float:
        """Fraction of non-empty steps served below full width."""
        return self.degraded_steps / self.steps if self.steps else 0.0

    def can_degrade(self) -> bool:
        return self.level < self.quality_floor

    def can_restore(self) -> bool:
        return self.level > 0

    def level_config(self, k: int):
        """Level `k`'s current configuration (the planned one, or the
        latest ``swap_configuration`` routed to it)."""
        return self._level_configs[k]

    def _pipeline_for(self, k: int):
        """Level `k`'s built pipeline, building (and caching) it on
        first use.  The build goes through ``_build_pipeline`` with
        the level's model/params temporarily published so subclass
        wrappers (contention-taxed engines) apply to every level."""
        pipe = self._pipelines.get(k)
        if pipe is None:
            tp = self.plan.levels[k]
            saved = (self.model, self.packed_params)
            self.model, self.packed_params = tp.model, self._packed[k]
            try:
                pipe = self._build_pipeline(self._level_configs[k])
            finally:
                self.model, self.packed_params = saved
            self._pipelines[k] = pipe
        return pipe

    def warm(self) -> None:
        """Pre-build every level's pipeline so the first degrade
        under overload doesn't stall on a build."""
        for k in range(len(self.plan)):
            self._pipeline_for(k)

    def set_level(self, k: int) -> bool:
        """Serve subnet level `k` from the next batch boundary on.

        Returns True when applied immediately, False when deferred to
        the end of the executing step (mirroring
        :meth:`swap_configuration`).  Raises when `k` violates the
        engine's ``quality_floor`` — the floor binds at the actuator.
        """
        k = int(k)
        if not 0 <= k < len(self.plan):
            raise ValueError(
                f"level {k} outside [0, {len(self.plan) - 1}]"
            )
        if k > self.quality_floor:
            raise ValueError(
                f"level {k} violates quality_floor {self.quality_floor}"
            )
        if k == self.level and self._pending_level is None:
            return True
        if self._in_step:
            self._pending_level = k
            return False
        self._apply_level(k)
        return True

    def _apply_level(self, k: int) -> None:
        if k == self.level:
            return
        pipe = self._pipeline_for(k)   # build first: a failed build
        #                                leaves the current level serving
        self._pipelines[self.level] = self.pipeline
        tp = self.plan.levels[k]
        self.model = tp.model
        self.packed_params = self._packed[k]
        self.config = self._level_configs[k]
        self.pipeline = pipe
        self.level = k
        self.level_switches += 1
        if self.telemetry is not None:
            # segment shapes changed: stale windows would register as
            # drift against the new level's predictions
            self.telemetry.reset()

    # -- ServingEngine overrides -------------------------------------
    def swap_configuration(self, config) -> bool:
        """Route `config` to the level whose model it was mapped for.

        A swap for the *serving* level behaves exactly like the parent
        (applied now or at the batch boundary); a swap for a dormant
        level just replaces that level's slot and drops its cached
        pipeline, taking effect whenever the level is next served."""
        target = None
        for k, c in enumerate(self._level_configs):
            if c.model_name == config.model_name:
                target = k
                break
        if target is None:
            raise ValueError(
                f"configuration for {config.model_name!r} matches no "
                f"subnet level of {self._level_configs[0].model_name!r}"
            )
        if config.proper_batch_size != self.config.proper_batch_size:
            raise ValueError(
                f"hot swap must preserve the serving batch size "
                f"(engine serves {self.config.proper_batch_size}, new "
                f"configuration is for {config.proper_batch_size}); "
                "build a new engine to change batch size"
            )
        self._level_configs[target] = config
        self._pipelines.pop(target, None)
        if target == self.level:
            return super().swap_configuration(config)
        return True

    def step(self, *, force: bool = False) -> int:
        served_level = self.level    # a deferred switch lands after
        done = super().step(force=force)
        if done and served_level > 0:
            self.degraded_steps += 1
        return done

    def _drain_pending_swap(self) -> None:
        super()._drain_pending_swap()
        if self._pending_level is not None:
            k, self._pending_level = self._pending_level, None
            self._apply_level(k)
