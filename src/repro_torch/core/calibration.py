"""Persistent hardware calibration (ROADMAP: recalibration persistence).

The censor-triggered :func:`~.contention.recalibrate_preset` refits the
:class:`~.contention.HardwareModel` mid-run — and discarded the refit at
process exit, so every subsequent run on the same host re-tripped the
censoring gate, re-accumulated raw pairs, and re-fit the same tables from
scratch. The paper's own §5.1 answer to host variance is *sampling-based
calibration of system properties persisted across runs* (its latency tables
are memoized to disk); this module applies the same idea to the runtime
refit.

A :class:`CalibrationStore` is a small JSON file holding, per
``(host fingerprint, backend, base preset)`` key:

* the refit :class:`~.contention.HardwareModel` payload, and
* the provenance ``(width, modeled_ns, measured_ns)`` pairs it was fit from
  (the raw unclipped tuples :meth:`~.feedback.CostFeedback.
  recalibration_pairs` accumulated), so a later refit can re-train from the
  union instead of starting blind.

The engine loads the store at construction
(``MultiQueryEngine(hw, calibration=...)``): when an entry matches the
host, the installed backend, and the base preset (at the current
:data:`~.contention.PRESET_VERSION`), the engine starts on the refit model
— calibrated from the first step, instead of spending the first run's
observations re-tripping ``censor_tripped``. After a run whose censoring
gate *does* trip, the freshly refit model is written back, so the store
converges on whatever host executes.

Trust boundaries, all fail-soft (a calibration file must never break an
engine): a missing file is a cold store; a corrupt file warns and is
treated as cold (then atomically overwritten on the next save); an entry
written by a *different* host fingerprint, backend, preset, or preset
version is ignored — stale calibration silently steering a different
machine is exactly the failure mode the fingerprint key exists to prevent.
"""
from __future__ import annotations

import json
import os
import platform
import warnings

from .contention import PRESET_VERSION, HardwareModel

# store document schema, independent of the preset tables' PRESET_VERSION
SCHEMA_VERSION = 1


def host_fingerprint() -> str:
    """A stable identifier for the executing host class.

    Deliberately coarse — OS, ISA, and logical core count — so that CI
    runners of the same image class share calibration (the actions/cache
    restore would otherwise never hit), while a laptop and a TPU VM never
    cross-contaminate. Not a unique machine id: two identical hosts
    *should* share an entry."""
    return (
        f"{platform.system()}-{platform.machine()}-c{os.cpu_count() or 0}".lower()
    )


class CalibrationStore:
    """Host/backend-keyed persistence for refit hardware models.

    ``path`` is the JSON file (created on first :meth:`save`);
    ``fingerprint`` defaults to :func:`host_fingerprint` and is overridable
    for tests. All reads are fail-soft: :meth:`load` / :meth:`load_pairs`
    return ``None`` / ``[]`` on any problem, warning only when the file
    exists but cannot be parsed."""

    def __init__(self, path: str, *, fingerprint: str | None = None):
        self.path = str(path)
        self.fingerprint = fingerprint or host_fingerprint()

    # ------------------------------------------------------------- keying
    def _key(self, preset: str, backend: str) -> str:
        """One entry per (host, backend, base preset @ preset version):
        measured ratios depend on all four — an inline-timed refit must not
        calibrate a CUDA run, and a preset-table change invalidates every
        refit derived from the old tables."""
        return f"{self.fingerprint}/{backend}/{preset}@v{PRESET_VERSION}"

    # -------------------------------------------------------------- read
    def _read(self) -> dict:
        """The parsed store document; ``{}`` when missing/corrupt/foreign.

        A corrupt or wrong-schema file warns (someone's calibration is
        about to be resynthesized from scratch — worth a breadcrumb) but
        never raises: the next :meth:`save` atomically replaces it."""
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return {}
        except (OSError, ValueError) as e:
            warnings.warn(
                f"calibration store {self.path!r} unreadable ({e}); "
                "starting cold",
                stacklevel=3,
            )
            return {}
        if (
            not isinstance(doc, dict)
            or doc.get("schema") != SCHEMA_VERSION
            or not isinstance(doc.get("entries"), dict)
        ):
            warnings.warn(
                f"calibration store {self.path!r} has an unknown shape; "
                "starting cold",
                stacklevel=3,
            )
            return {}
        return doc

    def _entry(self, preset: str, backend: str) -> dict | None:
        """The matching entry dict, or ``None``; re-checks the stamped
        fingerprint/backend/preset fields against the key (belt and braces
        against hand-edited or copied files)."""
        entry = self._read().get("entries", {}).get(self._key(preset, backend))
        if not isinstance(entry, dict) or not isinstance(entry.get("model"), dict):
            return None
        if (
            entry.get("fingerprint") != self.fingerprint
            or entry.get("backend") != backend
            or entry.get("preset") != preset
            or entry.get("preset_version") != PRESET_VERSION
        ):
            return None
        return entry

    def load(self, preset: str, backend: str) -> HardwareModel | None:
        """The refit model for (this host, ``backend``, ``preset``), or
        ``None`` when the store holds no matching trustworthy entry."""
        entry = self._entry(preset, backend)
        if entry is None:
            return None
        try:
            return HardwareModel.from_payload(entry["model"])
        except (KeyError, TypeError, ValueError) as e:
            warnings.warn(
                f"calibration entry for {preset!r}/{backend!r} in "
                f"{self.path!r} is malformed ({e}); ignoring it",
                stacklevel=2,
            )
            return None

    def load_pairs(self, preset: str, backend: str) -> list[tuple[int, float, float]]:
        """The provenance ``(width, modeled_ns, measured_ns)`` pairs the
        stored refit was fit from (``[]`` when absent) — the training set a
        later refit unions with its own fresh observations."""
        entry = self._entry(preset, backend)
        if entry is None:
            return []
        pairs = []
        for p in entry.get("pairs", []):
            try:
                w, mo, me = p
                pairs.append((int(w), float(mo), float(me)))
            except (TypeError, ValueError):
                return []  # a malformed pair poisons the provenance set
        return pairs

    # ------------------------------------------------------------- write
    def save(
        self,
        hw: HardwareModel,
        pairs: list[tuple[int, float, float]],
        *,
        preset: str,
        backend: str,
    ) -> None:
        """Write (or replace) this host's entry for ``(backend, preset)``.

        Other entries — other hosts sharing the file over a cache mount,
        other backends — are preserved; the write is an atomic rename so a
        crash cannot leave a half-written store."""
        doc = self._read()
        if not doc:
            doc = {"schema": SCHEMA_VERSION, "entries": {}}
        doc["entries"][self._key(preset, backend)] = {
            "fingerprint": self.fingerprint,
            "backend": backend,
            "preset": preset,
            "preset_version": PRESET_VERSION,
            "model": hw.to_payload(),
            "pairs": [[int(w), float(mo), float(me)] for w, mo, me in pairs],
        }
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, self.path)
