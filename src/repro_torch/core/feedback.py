"""Runtime → cost-estimator feedback (paper §4.4, dotted line — explicitly
left as future work: "it is also possible that some stage provides feedback
like the measured cost of a work package ... this might allow to optimize
later iterations"; we implement it).

Two granularities share one EWMA-of-log-ratio mechanism:

* **mode level** — after each iteration the engine reports
  ``(modeled_ns, measured_ns)`` via :meth:`CostFeedback.observe`; the EWMA of
  the log-ratio becomes a per-(algorithm, parallel-mode) correction factor
  applied to subsequent predictions. This compensates for systematic model
  error (mis-calibrated L_mem, cache effects the Eq. 12–14 interpolation
  misses) without touching the model structure.

* **width level** — every execution path that already carries exact
  per-package ``(width, modeled, measured)`` tuples — plain
  :class:`~.scheduler.ScheduleRun` steps, :class:`~.fusion.FusionMember`
  split-back commits, stolen-batch claims, and post-preemption residual
  runs — reports them via the width-keyed form of
  :meth:`CostFeedback.observe` (``observe(algorithm, mode, width=...,
  ...)``), keyed by ``(algorithm, width)``. This matters because three subsystems execute a
  query's packages at widths its own preparation never planned for: thief
  gangs, governor preemption/resume, and fused gangs running every member at
  the gang width instead of the member's own ``T_max``.

Lookup is hierarchical (:meth:`CostFeedback.correction`): exact width →
power-of-two width bucket → mode-level scalar → 1.0, so a cold width falls
back to whatever coarser signal exists. Every returned correction is clamped
to ``[1/clip, clip]`` — ``observe`` clips each *ratio* before the EWMA, but
the accumulated log sum is re-clamped on read so no parameterization (e.g.
an over-relaxed ``alpha > 1``) can walk a correction past the bound.

Consumers compare widths *relative to each other* via
:meth:`CostFeedback.width_ratio`: the width-keyed correction divided by the
mode-level scalar. The mode scalar carries the common-mode host-vs-model
offset (this host is not the paper's Xeon); the ratio isolates the
width-*dependent* residual — "width 16 measured 2x worse than this
algorithm's average" — which is the signal that should steer planning
(:func:`~.autotuner.prepare_iteration`), fused gang width sweeps
(:func:`~.fusion.plan_gang_width`) and thief gang sizing
(:meth:`~.stealing.StealRegistry.thief_gang_width`).

**Censoring.** When the model is badly mis-calibrated for the executing
host (e.g. the modeled clock targets the paper's Xeon while measurement
runs elsewhere), most raw ratios fall outside ``[1/clip, clip]`` and the
stored corrections pin at the bound. Two *censored* entries compared
against each other yield an artifact, not a differential — whichever width
happens to land inside the clip window looks spuriously efficient. The
tables therefore track the censored fraction per key, and
:meth:`width_ratio` returns the neutral 1.0 whenever either side of the
comparison is predominantly censored: a correction that only says "off by
at least clip×" cannot rank widths. Differentials steer decisions exactly
where they are trustworthy — a calibrated deployment (or one recalibrated
via :func:`~.contention.calibrate_from_runs`) whose ratios live inside the
clip window.
"""
from __future__ import annotations

import dataclasses
import math

from .scheduler import largest_pow2_leq


def _pow2_bucket(width: int) -> int:
    """Largest power of two ≤ ``width`` (bucket key for near-miss widths),
    clamped to ≥ 1 so width 0 degenerates to the sequential bucket."""
    return largest_pow2_leq(max(int(width), 1))


# raw (width, modeled_ns, measured_ns) pairs kept for recalibration: bounded
# so a long-lived engine cannot grow without bound (drop-oldest — the newest
# pairs describe the host best)
_RAW_PAIR_CAP = 4096


@dataclasses.dataclass
class CostFeedback:
    """Width-aware multiplicative cost corrections, EWMA'd in log space.

    Three correction tables, coarse to fine:

    * ``(algorithm, parallel)`` — the mode-level scalar,
      fed once per iteration by :meth:`observe`;
    * ``(algorithm, pow2-bucket)`` and ``(algorithm, exact width)`` — the
      width-keyed table, fed per executed step/batch by the width-keyed
      form of :meth:`observe`.

    ``observations`` counts mode-level observations only (backwards
    compatible); ``width_observations`` counts width-level ones; ``version``
    increments on every observation of either kind. Consumers that cache
    derived plans should stamp them with the ``width_ratio`` values the plan
    consumed (see the engine's shared-preparation cache) rather than these
    counters — ratios move far less often than observations arrive.
    """

    alpha: float = 0.2           # EWMA weight for new observations
    clip: float = 8.0            # bound corrections to [1/clip, clip]
    censor_trust: float = 0.5    # max censored fraction for width_ratio signal
    _log_corr: dict = dataclasses.field(default_factory=dict)
    _log_width: dict = dataclasses.field(default_factory=dict)
    _log_bucket: dict = dataclasses.field(default_factory=dict)
    # ("mode"|"width"|"bucket", *key) -> (censored_count, total_count)
    _censor: dict = dataclasses.field(default_factory=dict)
    # raw width-level (width, modeled_ns, measured_ns) pairs, *unclipped*:
    # the recalibration input (censor-triggered calibrate_from_runs) needs
    # the true host ratios the clip window hid from the EWMA tables
    _raw_pairs: list = dataclasses.field(default_factory=list)
    observations: int = 0
    width_observations: int = 0

    # ------------------------------------------------------------------ keys
    def _key(self, algorithm: str, parallel: bool) -> tuple:
        return (algorithm, parallel)

    @property
    def version(self) -> int:
        """Monotone change counter (any table): cache-invalidation key."""
        return self.observations + self.width_observations

    # ---------------------------------------------------------------- lookup
    def _clamped(self, log_corr: float) -> float:
        """exp of the accumulated log correction, re-clamped to the bound.

        ``observe`` clips each ratio *before* the EWMA, which bounds the
        accumulator for ``alpha ∈ (0, 1]`` — but nothing re-checked the sum
        on read, so an over-relaxed ``alpha`` (or hand-edited state) could
        yield corrections past ``clip``. Clamp at the single exit point."""
        bound = math.log(self.clip)
        return math.exp(max(min(log_corr, bound), -bound))

    def correction(
        self, algorithm: str, parallel: bool, width: int | None = None
    ) -> float:
        """Correction factor with hierarchical fallback.

        With ``width`` given: exact ``(algorithm, width)`` entry first, then
        the ``(algorithm, pow2-bucket)`` entry, then the mode-level scalar.
        Cold start (no observations on any level) returns 1.0."""
        if width is not None:
            w = int(width)
            lw = self._log_width.get((algorithm, w))
            if lw is not None:
                return self._clamped(lw)
            lb = self._log_bucket.get((algorithm, _pow2_bucket(w)))
            if lb is not None:
                return self._clamped(lb)
        return self._clamped(self._log_corr.get(self._key(algorithm, parallel), 0.0))

    def _distrusted(self, kind: str, *key) -> bool:
        """True when a key's observations were predominantly censored (raw
        ratios clipped): its stored correction only bounds the error, so it
        cannot participate in a width-vs-width comparison. A cold key is
        *not* distrusted — its neutral 1.0 is exact."""
        c, t = self._censor.get((kind, *key), (0, 0))
        return t > 0 and c / t >= self.censor_trust

    def width_ratio(self, algorithm: str, width: int) -> float:
        """Width-keyed correction *relative to* the mode-level scalar.

        > 1.0: width ``width`` measured worse than the algorithm's mode
        average (plan narrower); < 1.0: better (plan wider); 1.0 when the
        width table is cold or carries the same signal as the scalar. The
        division cancels the common-mode host-vs-model offset, leaving only
        the width-dependent residual — the planning signal.

        Returns the neutral 1.0 whenever either side of the comparison is
        predominantly censored (see the module docstring): clip-pinned
        corrections rank widths by *which ones happened to clip*, not by
        measured efficiency.

        The reference is the scalar of the width's own mode when that mode
        has observations, else the *other* mode's scalar: width-1 entries
        are fed per step (sequential grinding inside parallel iterations
        included) while the ``(algorithm, False)`` scalar is only fed by
        fully-sequential iterations — in a parallel-dominated workload it
        stays cold, and dividing by its neutral 1.0 would leave the
        common-mode host offset uncancelled at width 1 exactly."""
        w = int(width)
        parallel = w >= 2
        entry_key = (algorithm, w)
        if entry_key in self._log_width:
            level, log_corr = "width", self._log_width[entry_key]
        else:
            entry_key = (algorithm, _pow2_bucket(w))
            if entry_key not in self._log_bucket:
                return 1.0
            level, log_corr = "bucket", self._log_bucket[entry_key]
        ref_mode = parallel
        if self._key(algorithm, ref_mode) not in self._log_corr and (
            self._key(algorithm, not ref_mode) in self._log_corr
        ):
            ref_mode = not ref_mode
        if self._distrusted(level, *entry_key) or self._distrusted(
            "mode", algorithm, ref_mode
        ):
            return 1.0
        mode = self._clamped(self._log_corr.get(self._key(algorithm, ref_mode), 0.0))
        if mode <= 0:
            return 1.0
        return self._clamped(log_corr) / mode

    def width_censored(self, algorithm: str, width: int) -> bool:
        """True when :meth:`width_ratio` for this key returns the neutral 1.0
        *because of censoring* — the signal it would consult (exact width,
        else pow2 bucket, or its mode reference) is predominantly clipped.

        A cold key is **not** censored: its neutral 1.0 is exact, not a
        bound. Heterogeneous gang planning uses this to detect algorithms
        whose width entries cannot rank widths (the most-conservative-member
        fallback of :func:`~.fusion.plan_hetero_gang_width`)."""
        w = int(width)
        entry_key = (algorithm, w)
        if entry_key in self._log_width:
            level = "width"
        else:
            entry_key = (algorithm, _pow2_bucket(w))
            if entry_key not in self._log_bucket:
                return False  # cold, not censored
            level = "bucket"
        ref_mode = w >= 2
        if self._key(algorithm, ref_mode) not in self._log_corr and (
            self._key(algorithm, not ref_mode) in self._log_corr
        ):
            ref_mode = not ref_mode
        return self._distrusted(level, *entry_key) or self._distrusted(
            "mode", algorithm, ref_mode
        )

    def width_algorithms(self) -> list[str]:
        """Algorithms with at least one width-level observation (sorted):
        the population the admission controller's measured efficiency
        frontier is computed over."""
        return sorted({a for a, _ in self._log_width})

    # ------------------------------------------------------- recalibration
    def censor_tripped(self, *, min_observations: int = 8) -> bool:
        """The censoring gate: True when the width-level observations
        are *predominantly* censored overall (fraction ≥ ``censor_trust``
        over ≥ ``min_observations`` samples) — the modeled clock is so far
        off the executing host that the clip window hides the differential
        width signal. The cure is not neutralizing the table but
        recalibrating the hardware model from the accumulated raw pairs
        (:func:`~.contention.recalibrate_preset`)."""
        c = t = 0
        for (kind, *_key), (ck, tk) in self._censor.items():
            if kind == "width":
                c += ck
                t += tk
        return t >= min_observations and c / t >= self.censor_trust

    def recalibration_pairs(self) -> list[tuple[int, float, float]]:
        """The accumulated raw ``(width, modeled_ns, measured_ns)`` pairs
        (unclipped — the true host ratios), newest last. These are also the
        provenance set a :class:`~.calibration.CalibrationStore` persists
        next to a refit model, so later refits on the same (host, backend)
        train on every pair ever measured there, not one run's buffer."""
        return list(self._raw_pairs)

    def reset_width_state(self) -> None:
        """Forget every measured correction and censor count (mode, width,
        bucket) and the raw pair buffer. Called after a recalibration swaps
        the hardware model underneath the tables: corrections learned
        against the old model are systematically wrong against the new one,
        and the censor history would keep reporting a gate that the
        recalibration just addressed."""
        self._log_corr.clear()
        self._log_width.clear()
        self._log_bucket.clear()
        self._censor.clear()
        self._raw_pairs.clear()

    # -------------------------------------------------------------- updates
    def _ewma(self, table: dict, key: tuple, ratio: float) -> None:
        prev = table.get(key, 0.0)
        table[key] = (1 - self.alpha) * prev + self.alpha * math.log(ratio)

    def _note_censor(self, kind: str, key: tuple, censored: bool) -> None:
        c, t = self._censor.get((kind, *key), (0, 0))
        self._censor[(kind, *key)] = (c + int(censored), t + 1)

    def _clip_ratio(
        self, modeled_ns: float, measured_ns: float
    ) -> tuple[float, bool] | None:
        """``(clipped_ratio, was_censored)``; None for degenerate inputs."""
        if modeled_ns <= 0 or measured_ns <= 0:
            return None
        raw = measured_ns / modeled_ns
        clipped = max(min(raw, self.clip), 1.0 / self.clip)
        return clipped, clipped != raw

    def observe(
        self,
        algorithm: str,
        mode: str,
        width: int | float | None = None,
        modeled_ns: float | None = None,
        measured_ns: float | None = None,
    ) -> None:
        """Unified observation entry point (the one call backends report to).

        ``mode`` is ``"parallel"`` or ``"sequential"``. With ``width=None``
        this is a *mode-level* observation — one finished iteration's totals,
        feeding the per-(algorithm, mode) scalar. With a width it is a
        *width-level* observation — one executed step/batch at that gang
        width, feeding both the exact-width entry and its power-of-two
        bucket (they coincide when ``width`` is itself a power of two — the
        common case, since granted gangs round down to usable powers of
        two — but the bucket is kept separately so near-miss widths, e.g.
        12 → bucket 8, inherit the signal of the widths the engine actually
        executed). The two granularities stay separate tables: a width
        observation never moves the mode scalar, and vice versa.

        The pre-unification positional shape ``observe(algorithm, parallel:
        bool, modeled_ns, measured_ns)`` had a one-release deprecation
        window and is now rejected outright (the boolean mode falls through
        to the mode check below)."""
        if mode not in ("parallel", "sequential"):
            raise ValueError(f"mode must be 'parallel' or 'sequential', got {mode!r}")
        if modeled_ns is None or measured_ns is None:
            raise TypeError("observe requires modeled_ns and measured_ns")
        if width is None:
            self._observe_mode(algorithm, mode == "parallel", modeled_ns, measured_ns)
        else:
            self._observe_width(algorithm, int(width), modeled_ns, measured_ns)

    def _observe_mode(
        self, algorithm: str, parallel: bool, modeled_ns: float, measured_ns: float
    ) -> None:
        clipped = self._clip_ratio(modeled_ns, measured_ns)
        if clipped is None:
            return
        ratio, censored = clipped
        key = self._key(algorithm, parallel)
        self._ewma(self._log_corr, key, ratio)
        self._note_censor("mode", key, censored)
        self.observations += 1

    def _observe_width(
        self, algorithm: str, width: int, modeled_ns: float, measured_ns: float
    ) -> None:
        clipped = self._clip_ratio(modeled_ns, measured_ns)
        if clipped is None:
            return
        ratio, censored = clipped
        w = max(int(width), 1)
        self._raw_pairs.append((w, float(modeled_ns), float(measured_ns)))
        if len(self._raw_pairs) > _RAW_PAIR_CAP:
            del self._raw_pairs[: len(self._raw_pairs) - _RAW_PAIR_CAP]
        self._ewma(self._log_width, (algorithm, w), ratio)
        self._note_censor("width", (algorithm, w), censored)
        bucket = (algorithm, _pow2_bucket(w))
        self._ewma(self._log_bucket, bucket, ratio)
        self._note_censor("bucket", bucket, censored)
        self.width_observations += 1

    # ----------------------------------------------------------- predictions
    def predict(
        self,
        algorithm: str,
        parallel: bool,
        modeled_ns: float,
        width: int | None = None,
    ) -> float:
        """Corrected prediction for the next iteration (width-aware when a
        width is given)."""
        return modeled_ns * self.correction(algorithm, parallel, width=width)

    def error_db(
        self,
        algorithm: str,
        parallel: bool,
        modeled_ns: float,
        measured_ns: float,
        width: int | None = None,
    ) -> float:
        """|log10 prediction error| after correction (for tests/telemetry)."""
        pred = self.predict(algorithm, parallel, modeled_ns, width=width)
        return abs(math.log10(max(pred, 1e-9) / max(measured_ns, 1e-9)))
