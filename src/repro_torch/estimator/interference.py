"""Calibrated interference law, fitted from metered co-run slowdowns.

``cost_model.contention_inflation`` prices cross-tenant contention
with an *assumed* linear law ``1 + gamma * share``.  This module fits
the law from metered data instead: a device-time ledger (the fleet
tier's ``DeviceTimeLedger``, or any object with its ``tenants``,
``co_runner_share`` and ``step_rows`` methods) meters every tenant's
per-step host/device occupancy, so each closed step yields an
observed **inflation** (measured occupancy over the solo expectation)
at a known **co-runner share** — exactly the (x, y) pairs the law
maps.

:func:`fit_gamma` recovers the linear coefficient by least squares
through the origin (the law is pinned at ``inflation(0) == 1``);
:meth:`InterferenceFit.fit` optionally refines it into a
piecewise-affine law: observations are bucketed by share, bucket
means are made monotone by pool-adjacent-violators isotonic
regression, and the resulting knots interpolate between ``(0, 1)``
and the largest observed share (linear ``gamma`` extrapolation
beyond).

**Fitted-law contract** (what every consumer may assume, and the
property tests pin): for any observation set, the returned
:class:`FittedInterference` satisfies

* ``inflation(0.0) == 1.0`` — no co-runners, no slowdown;
* ``inflation(s) >= 1.0`` for all ``s >= 0`` — co-runners never
  speed you up;
* ``inflation`` is monotone non-decreasing in the share — the
  property a joint (fleet) mapper's never-worse-than-all-GPU descent
  relies on.

The fitted law threads through
:func:`repro_torch.core.cost_model.contention_inflation` (``law=``
param), replacing the fixed gamma wherever a law is supplied.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class InterferenceObservation:
    """One (co-runner share, measured inflation) sample."""

    share: float          # co-runners' summed occupancy share
    inflation: float      # measured_s / solo_expected_s
    placement: str = ""   # "host"/"device" (attribution only)
    tenant: str = ""


def fit_gamma(observations) -> float:
    """Least-squares linear coefficient through the pinned origin
    ``inflation(0) == 1``: ``gamma = sum(s*(f-1)) / sum(s^2)``,
    clamped non-negative (the law's domain)."""
    num = den = 0.0
    for o in observations:
        s = max(0.0, float(o.share))
        num += s * (float(o.inflation) - 1.0)
        den += s * s
    if den <= 0.0:
        return 0.0
    return max(0.0, num / den)


def _isotonic(ys, ws) -> list:
    """Weighted pool-adjacent-violators: the monotone non-decreasing
    sequence closest (weighted L2) to `ys`."""
    blocks: list = []   # [mean, weight, count]
    for y, w in zip(ys, ws):
        blocks.append([float(y), float(w), 1])
        while len(blocks) > 1 and blocks[-2][0] > blocks[-1][0]:
            m2, w2, c2 = blocks.pop()
            m1, w1, c1 = blocks.pop()
            wt = w1 + w2
            blocks.append([(m1 * w1 + m2 * w2) / wt, wt, c1 + c2])
    out: list = []
    for m, _, c in blocks:
        out.extend([m] * c)
    return out


@dataclasses.dataclass(frozen=True)
class FittedInterference:
    """A calibrated inflation law: linear ``1 + gamma*s`` when
    ``knots`` is empty, else piecewise-affine through ``(0, 1)`` and
    the (share, inflation) knots, extrapolating past the last knot at
    slope ``gamma``.  Knots are strictly increasing in share and
    non-decreasing >= 1 in inflation by construction (PAV + clamps in
    :meth:`InterferenceFit.fit`), so the law honors the module's
    fitted-law contract."""

    gamma: float
    knots: tuple = ()
    n_obs: int = 0
    residual: float = 0.0   # RMS of (observed - linear fit)

    def __post_init__(self):
        if self.gamma < 0.0:
            raise ValueError("gamma must be non-negative")

    def inflation(self, share: float) -> float:
        s = max(0.0, float(share))
        if not self.knots:
            return 1.0 + self.gamma * s
        pts = ((0.0, 1.0),) + tuple(
            (float(k[0]), float(k[1])) for k in self.knots
        )
        for (s0, f0), (s1, f1) in zip(pts, pts[1:]):
            if s <= s1:
                if s1 <= s0:
                    return max(f0, f1)
                t = (s - s0) / (s1 - s0)
                return f0 + t * (f1 - f0)
        s_last, f_last = pts[-1]
        return f_last + self.gamma * (s - s_last)

    def to_json(self) -> str:
        return json.dumps(
            {
                "schema": 1,
                "kind": "interference_law",
                "gamma": self.gamma,
                "knots": [[s, f] for s, f in self.knots],
                "n_obs": self.n_obs,
                "residual": self.residual,
            },
            indent=2,
        )

    @staticmethod
    def from_json(s: str) -> "FittedInterference":
        d = json.loads(s)
        if d.get("kind", "interference_law") != "interference_law":
            raise ValueError(
                f"expected an interference_law document, got "
                f"{d.get('kind')!r}"
            )
        return FittedInterference(
            gamma=float(d["gamma"]),
            knots=tuple(
                (float(s_), float(f)) for s_, f in d.get("knots", ())
            ),
            n_obs=int(d.get("n_obs", 0)),
            residual=float(d.get("residual", 0.0)),
        )


class InterferenceFit:
    """Accumulates (share, inflation) observations and fits the law."""

    def __init__(self):
        self._obs: list = []

    def __len__(self) -> int:
        return len(self._obs)

    def observations(self) -> tuple:
        return tuple(self._obs)

    def observe(
        self,
        share: float,
        inflation: float,
        *,
        placement: str = "",
        tenant: str = "",
    ) -> None:
        """Record one sample.  Negative shares and non-positive
        inflations are measurement garbage and dropped."""
        if share < 0.0 or inflation <= 0.0:
            return
        self._obs.append(
            InterferenceObservation(
                share=float(share),
                inflation=float(inflation),
                placement=placement,
                tenant=tenant,
            )
        )

    def add(self, obs: InterferenceObservation) -> None:
        self.observe(
            obs.share, obs.inflation,
            placement=obs.placement, tenant=obs.tenant,
        )

    def add_ledger(
        self,
        ledger,
        expected_step_s: dict,
        *,
        min_expected_s: float = 1e-9,
    ) -> int:
        """Harvest observations from a device-time ledger.

        ``expected_step_s`` maps tenant name to its **solo** expected
        (host_s, device_s) per engine step — the uninflated
        ``stage_times`` of the served configuration at its batch.
        Each closed step's measured occupancy over that expectation
        is one inflation sample at the tenant's current co-runner
        share on that processor.  Returns the number of observations
        added.  Stages expected to take under `min_expected_s` are
        skipped (a zero-work stage's ratio is noise, not signal).
        """
        from repro_torch.core.mapper import DEVICE, HOST

        added = 0
        for tenant in ledger.tenants():
            expected = expected_step_s.get(tenant)
            if expected is None:
                continue
            exp_host, exp_dev = float(expected[0]), float(expected[1])
            co = {
                HOST: ledger.co_runner_share(tenant, HOST),
                DEVICE: ledger.co_runner_share(tenant, DEVICE),
            }
            for host_s, dev_s in ledger.step_rows(tenant):
                for placement, measured, solo in (
                    (HOST, host_s, exp_host),
                    (DEVICE, dev_s, exp_dev),
                ):
                    if solo < min_expected_s or measured <= 0.0:
                        continue
                    self.observe(
                        co[placement],
                        measured / solo,
                        placement=placement,
                        tenant=tenant,
                    )
                    added += 1
        return added

    @classmethod
    def from_ledger(
        cls, ledger, expected_step_s: dict, **kwargs
    ) -> "InterferenceFit":
        fit = cls()
        fit.add_ledger(ledger, expected_step_s, **kwargs)
        return fit

    def fit(
        self,
        *,
        refine: bool = True,
        max_knots: int = 6,
        min_per_knot: int = 4,
    ) -> FittedInterference:
        """Fit the law from the accumulated observations.

        Always fits the linear ``gamma``; with ``refine``, enough
        positive-share observations also produce isotonic
        piecewise-affine knots (equal-count share buckets, bucket
        means, PAV for monotonicity, clamped >= 1).  With no
        observations the identity law (``gamma=0``) is returned —
        callers keep their fixed-gamma fallback for the cold case.
        """
        gamma = fit_gamma(self._obs)
        n = len(self._obs)
        if n:
            sq = sum(
                (o.inflation - (1.0 + gamma * max(0.0, o.share))) ** 2
                for o in self._obs
            )
            residual = (sq / n) ** 0.5
        else:
            residual = 0.0

        knots: tuple = ()
        if refine:
            pos = sorted(
                (o for o in self._obs if o.share > 1e-9),
                key=lambda o: o.share,
            )
            k = min(int(max_knots), len(pos) // max(1, int(min_per_knot)))
            if k >= 2:
                buckets = [
                    pos[(j * len(pos)) // k: ((j + 1) * len(pos)) // k]
                    for j in range(k)
                ]
                buckets = [b for b in buckets if b]
                shares = [
                    sum(o.share for o in b) / len(b) for b in buckets
                ]
                means = [
                    sum(o.inflation for o in b) / len(b) for b in buckets
                ]
                weights = [float(len(b)) for b in buckets]
                iso = _isotonic(means, weights)
                out: list = []
                for s, f in zip(shares, iso):
                    f = max(1.0, f)
                    if s <= 1e-9 or (out and s <= out[-1][0]):
                        continue
                    out.append((s, f))
                if len(out) >= 2:
                    knots = tuple(out)

        return FittedInterference(
            gamma=gamma, knots=knots, n_obs=n, residual=residual
        )
