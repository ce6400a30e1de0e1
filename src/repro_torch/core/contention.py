"""Update-contention model (paper §5, Equations 11–14).

The paper's move: don't model cache-coherence/collective contention
analytically — *calibrate* a latency table L(M, T) with a reference kernel
(degree count) over exponentially spaced thread counts T and touched-memory
sizes M, then predict by log-space polynomial interpolation between the
enclosing memory-hierarchy levels:

    S(M)      = (log M_l − log M) / (log M_l − log M_u)            (Eq. 12)
    δL(T, l)  = L(M_l, T) − L(M_u, T)                              (Eq. 13*)
    L_predict = L(M_l, T) − δL(T) · S(M)³                          (Eq. 14)

(*) Eq. (13) as printed computes L(M_u)−L(M_l) which, combined with Eq. (14),
would move the prediction *away* from the faster level as M approaches it; we
implement the evidently intended direction (δL ≥ 0, prediction slides from
L(M_l) at S=0 to L(M_u) at S=1) and record the deviation here for fidelity.

Level selection: l = min{x : M_x > M}; u = l−1; the l=1 special case (fits in
the innermost level) sets u = l. M beyond main memory is rejected, as in the
paper.

One hardware preset ships with the port:
  * ``XEON_E5_2660V4`` — the paper's evaluation machine (2×14 cores, HT, 35 MB
    LLC/socket, DDR4), with latency tables synthesized from published
    latencies + the paper's Fig. 4/5 shapes. Used to reproduce the paper's
    scheduling decisions.

``calibrate_from_runs`` builds a model from actual measurements (the degree
count benchmark in ``benchmarks/fig04_contention.py`` produces them), which is
the paper's §5.1 training procedure; tables are memoized to disk.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Sequence

import numpy as np

# Version stamp of the built-in preset tables (XEON_E5_2660V4
# and the HardwareModel field set). Bump on any change to the synthesized
# latencies, machine constants, or payload schema: the calibration store
# (core/calibration.py) keys its entries on it, and CI's cached calibration
# file uses it in the actions/cache key, so a preset change invalidates every
# refit derived from the old tables instead of silently steering with them.
PRESET_VERSION = 1


@dataclasses.dataclass(frozen=True)
class MemoryLevel:
    """One level of the calibrated memory hierarchy (name + capacity)."""

    name: str
    capacity: int  # bytes


@dataclasses.dataclass
class HardwareModel:
    """Calibrated latency model + machine constants (Table 3 parameters)."""

    name: str
    levels: list[MemoryLevel]                  # innermost → outermost
    thread_counts: list[int]                   # exponentially spaced T (§5.1)
    lat_mem: np.ndarray                        # [n_levels] ns / access, T=1
    lat_atomic: np.ndarray                     # [n_levels, n_threads] ns / atomic
    l_op: float = 0.3                          # ns / arithmetic op
    max_threads: int = 1                       # P (cores or device-group cap)
    c_thread_overhead_ns: float = 3_000.0      # C_T_overhead (a few µs)
    c_para_startup_ns: float = 5_000.0         # C_para_startup (a few µs)
    c_t_min_work_ns: float = 20_000.0          # C_T_min (> C_T_overhead)
    max_packages_factor: int = 8               # §4.2: packages ≤ 8 × parallelism
    # Locality domains: a step executed off its home domain streams the graph
    # across the socket interconnect (QPI / ICI), inflating every access by a
    # remote factor; migrating a session or stolen batch additionally pays a
    # one-time cache/state transfer cost.
    c_remote_factor: float = 1.35              # remote-domain access inflation
    c_migration_ns: float = 20_000.0           # one-time cross-domain move cost

    # ---------------- level selection + Eq. 12–14 ----------------

    def level_index(self, m_bytes: float) -> int:
        """l = min{x : M_x > M}. Raises if M exceeds the outermost level."""
        for i, lvl in enumerate(self.levels):
            if lvl.capacity > m_bytes:
                return i
        raise ValueError(
            f"touched memory {m_bytes:.3g} B exceeds outermost level "
            f"{self.levels[-1].name} of {self.name}"
        )

    def s_interp(self, m_bytes: float) -> tuple[int, int, float]:
        """Return (l, u, S(M)) per Eq. 12 with the l=0 special case."""
        l = self.level_index(m_bytes)
        if l == 0:
            return 0, 0, 0.0
        u = l - 1
        m_l = self.levels[l].capacity
        m_u = self.levels[u].capacity
        m = min(max(m_bytes, 1.0), m_l)
        s = (math.log(m_l) - math.log(m)) / (math.log(m_l) - math.log(m_u))
        return l, u, min(max(s, 0.0), 1.0)

    def _thread_slot(self, t: int) -> tuple[int, int, float]:
        """Bracketing measured thread counts + geometric mix for T lookup."""
        ts = self.thread_counts
        t = max(1, min(int(t), ts[-1]))
        if t <= ts[0]:
            return 0, 0, 0.0
        for i in range(len(ts) - 1):
            if ts[i] <= t <= ts[i + 1]:
                if ts[i] == t:
                    return i, i, 0.0
                frac = (math.log(t) - math.log(ts[i])) / (
                    math.log(ts[i + 1]) - math.log(ts[i])
                )
                return i, i + 1, frac
        return len(ts) - 1, len(ts) - 1, 0.0

    def _lat_at(self, table_row: np.ndarray, t: int) -> float:
        i, j, frac = self._thread_slot(t)
        return float(table_row[i] * (1 - frac) + table_row[j] * frac)

    def l_mem(self, m_bytes: float) -> float:
        """L_mem(M): non-atomic access latency via Eq. 12/14 interpolation."""
        l, u, s = self.s_interp(m_bytes)
        lat_l = float(self.lat_mem[l])
        lat_u = float(self.lat_mem[u])
        delta = lat_l - lat_u
        return lat_l - delta * s**3

    def l_atomic(self, t: int, m_bytes: float) -> float:
        """L_atomic(T, M) per Eq. 14; L_atomic(1, M) == L_mem(M) (§3.2)."""
        if t <= 1:
            return self.l_mem(m_bytes)
        l, u, s = self.s_interp(m_bytes)
        lat_l = self._lat_at(self.lat_atomic[l], t)
        lat_u = self._lat_at(self.lat_atomic[u], t)
        delta = lat_l - lat_u
        return lat_l - delta * s**3

    # ---------------- persistence (memoized calibration, §4.1.1) ----------------

    def to_payload(self) -> dict:
        """The model as a JSON-serializable dict (:meth:`save`'s document;
        also embedded per-entry by :class:`~.calibration.CalibrationStore`)."""
        return dict(
            name=self.name,
            levels=[(l.name, l.capacity) for l in self.levels],
            thread_counts=self.thread_counts,
            lat_mem=self.lat_mem.tolist(),
            lat_atomic=self.lat_atomic.tolist(),
            l_op=self.l_op,
            max_threads=self.max_threads,
            c_thread_overhead_ns=self.c_thread_overhead_ns,
            c_para_startup_ns=self.c_para_startup_ns,
            c_t_min_work_ns=self.c_t_min_work_ns,
            max_packages_factor=self.max_packages_factor,
            c_remote_factor=self.c_remote_factor,
            c_migration_ns=self.c_migration_ns,
        )

    def save(self, path: str) -> None:
        """Persist the calibrated model as JSON (atomic rename)."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_payload(), f)
        os.replace(tmp, path)

    @classmethod
    def from_payload(cls, p: dict) -> "HardwareModel":
        """Rebuild a model from a :meth:`to_payload` dict (raises
        ``KeyError``/``ValueError`` on malformed input — callers that must
        be fail-soft, like the calibration store, catch and ignore)."""
        return cls(
            name=p["name"],
            levels=[MemoryLevel(n, c) for n, c in p["levels"]],
            thread_counts=list(p["thread_counts"]),
            lat_mem=np.asarray(p["lat_mem"], dtype=np.float64),
            lat_atomic=np.asarray(p["lat_atomic"], dtype=np.float64),
            l_op=p["l_op"],
            max_threads=p["max_threads"],
            c_thread_overhead_ns=p["c_thread_overhead_ns"],
            c_para_startup_ns=p["c_para_startup_ns"],
            c_t_min_work_ns=p["c_t_min_work_ns"],
            max_packages_factor=p["max_packages_factor"],
            # calibration files written before locality domains lack these
            c_remote_factor=p.get("c_remote_factor", 1.35),
            c_migration_ns=p.get("c_migration_ns", 20_000.0),
        )

    @classmethod
    def load(cls, path: str) -> "HardwareModel":
        """Load a model previously written by :meth:`save`."""
        with open(path) as f:
            return cls.from_payload(json.load(f))


def calibrate_from_runs(
    name: str,
    levels: Sequence[MemoryLevel],
    thread_counts: Sequence[int],
    sizes_bytes: Sequence[float],
    measured_ns: np.ndarray,  # [len(sizes), len(thread_counts)]
    **constants,
) -> HardwareModel:
    """Build a HardwareModel from degree-count measurements (§5.1 training).

    For each memory level we take the measurement at the largest size that
    still fits the level (the paper measures at sizes straddling each level).
    """
    sizes = np.asarray(sizes_bytes, dtype=np.float64)
    measured = np.asarray(measured_ns, dtype=np.float64)
    n_levels = len(levels)
    lat_atomic = np.zeros((n_levels, len(thread_counts)))
    for li, lvl in enumerate(levels):
        fits = np.where(sizes < lvl.capacity)[0]
        idx = fits[-1] if fits.size else 0
        lat_atomic[li] = measured[idx]
    lat_mem = lat_atomic[:, 0].copy()  # L_atomic(T=1) == L_mem (§3.2)
    return HardwareModel(
        name=name,
        levels=list(levels),
        thread_counts=list(thread_counts),
        lat_mem=lat_mem,
        lat_atomic=lat_atomic,
        max_threads=int(thread_counts[-1]),
        **constants,
    )


def recalibrate_preset(
    hw: HardwareModel,
    pairs: Sequence[tuple[int, float, float]],
    *,
    name: str | None = None,
) -> HardwareModel:
    """Converge a preset toward the executing host from runtime observations.

    ``pairs`` are the raw per-step ``(width, modeled_ns, measured_ns)``
    tuples the §4.4 feedback loop accumulates
    (:meth:`~.feedback.CostFeedback.recalibration_pairs`). When the
    censoring gate trips — the host is so far from the preset that every
    clipped ratio pins at the bound and the width table carries no readable
    differential — the honest fix is re-training the latency tables, not
    neutralizing the corrections.

    Procedure (the §5.1 training path, re-driven by runtime data): each pair
    is bucketed onto the preset's nearest measured thread count
    (geometrically — the tables are log-spaced); the per-slot *median*
    measured/modeled ratio scales that slot's latency column, empty slots
    inherit the global median (a uniform host offset recalibrates every
    width even from narrow observations). The scaled table is then fed
    through :func:`calibrate_from_runs` — one synthetic size per memory
    level, just under its capacity, so the §5.1 largest-fitting-size
    selection reconstructs exactly the scaled per-level rows — yielding a
    model whose predicted ratios land back inside the clip window, making
    the differential width signal readable again.

    With no usable pairs the preset is returned unchanged (same object)."""
    ratios: dict[int, list[float]] = {}
    all_ratios: list[float] = []
    ts = hw.thread_counts
    for width, modeled_ns, measured_ns in pairs:
        if modeled_ns <= 0 or measured_ns <= 0:
            continue
        w = max(int(width), 1)
        # nearest measured thread count in log space (the tables' own axis)
        slot = min(
            range(len(ts)),
            key=lambda i: abs(math.log(ts[i]) - math.log(w)),
        )
        r = measured_ns / modeled_ns
        ratios.setdefault(slot, []).append(r)
        all_ratios.append(r)
    if not all_ratios:
        return hw
    global_scale = float(np.median(all_ratios))
    scale = np.array(
        [
            float(np.median(ratios[i])) if i in ratios else global_scale
            for i in range(len(ts))
        ]
    )
    sizes = [0.5 * lvl.capacity for lvl in hw.levels]
    measured = np.asarray(hw.lat_atomic, dtype=np.float64) * scale[None, :]
    return calibrate_from_runs(
        name or f"{hw.name}+recal",
        hw.levels,
        ts,
        sizes,
        measured,
        l_op=hw.l_op * global_scale,
        c_thread_overhead_ns=hw.c_thread_overhead_ns,
        c_para_startup_ns=hw.c_para_startup_ns,
        c_t_min_work_ns=hw.c_t_min_work_ns,
        max_packages_factor=hw.max_packages_factor,
        c_remote_factor=hw.c_remote_factor,
        c_migration_ns=hw.c_migration_ns,
    )


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

def _xeon_preset() -> HardwareModel:
    """Paper machine: 2× Xeon E5-2660 v4 (14C/28T each), 35 MB LLC/socket.

    Latency tables follow published access latencies and the qualitative
    shapes of the paper's Fig. 4 (latency grows ~log M across levels) and
    Fig. 5 (thread count hurts most when the problem fits in cache)."""
    levels = [
        MemoryLevel("L1", 32 * 1024),
        MemoryLevel("L2", 256 * 1024),
        MemoryLevel("LLC", 35 * 1024 * 1024),
        MemoryLevel("DRAM", 128 * 1024**3),
    ]
    threads = [1, 2, 4, 8, 16, 32, 56]
    lat_mem = np.array([1.5, 4.0, 16.0, 90.0])
    # atomic update latency [level, T]: contention multiplies small-level cost
    # (cache-line ping-pong); DRAM-resident arrays spread contention (Fig. 4).
    base = lat_mem[:, None]
    t = np.array(threads, dtype=np.float64)[None, :]
    gamma = np.array([3.0, 2.0, 0.9, 0.12])[:, None]  # per-level contention slope
    lat_atomic = base * (1.0 + gamma * np.log2(t))
    lat_atomic[:, 0] = lat_mem  # T=1 identity
    return HardwareModel(
        name="xeon_e5_2660v4",
        levels=levels,
        thread_counts=threads,
        lat_mem=lat_mem,
        lat_atomic=lat_atomic,
        l_op=0.3,
        max_threads=56,
        c_thread_overhead_ns=3_000.0,
        c_para_startup_ns=5_000.0,
        c_t_min_work_ns=20_000.0,
        c_remote_factor=1.35,       # ~QPI-remote DRAM latency / local (2-socket)
        c_migration_ns=20_000.0,    # warm-cache refill after a cross-socket move
    )


XEON_E5_2660V4 = _xeon_preset()

PRESETS = {
    "xeon_e5_2660v4": XEON_E5_2660V4,
}


def counter_array_bytes(num_counters: int, counter_size: int = 4) -> float:
    """Eq. (11): M_counters = sizeof(counter) · |V|."""
    return float(counter_size) * float(num_counters)


def cross_domain_cost_ns(hw: HardwareModel, base_ns: float) -> float:
    """Cost of running a ``base_ns`` batch on a remote locality domain.

    Every access streams over the domain interconnect (``c_remote_factor``)
    and the move itself pays a one-time migration cost (``c_migration_ns``:
    cold caches on the thief socket, restaged shard tables on a TPU slice).
    Used by the stealing path when a thief grabs work across domains and by
    the step cost when a session executes off its home domain."""
    return float(base_ns) * hw.c_remote_factor + hw.c_migration_ns
