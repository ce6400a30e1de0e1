"""The port's persistent hardware calibration (``repro_torch.core.
calibration``) against the JAX package's, test for test with
``tests/test_calibration.py``: the same fingerprint, the same store
documents (a file either package writes loads in the other, byte-equal
payloads), the same cold/warm decisions on mismatched keys and damaged
files, and the same engine write-back and refit pairs in a censor-tripping
run, with the reference's assertions held on the port."""
import json
import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from _torch_parity import both, plain, port_graph  # noqa: E402
from _torch_bench_rows import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread a test)

PRESET = tcore.XEON_E5_2660V4.name
PAIRS = [(w, 1e4, 2e5) for w in (1, 2, 4, 8) for _ in range(4)]
PKGS = {"jax": jcore, "torch": tcore}


def _refit(core=tcore):
    hw = core.recalibrate_preset(core.XEON_E5_2660V4, PAIRS, name=f"{PRESET}+recal")
    assert hw is not core.XEON_E5_2660V4
    return hw


@pytest.fixture
def store_path(tmp_path):
    return str(tmp_path / "calibration.json")


@pytest.fixture(scope="module")
def graphs(small_rmat):
    return {"jax": small_rmat, "torch": port_graph(small_rmat)}


def _payload(hw):
    return None if hw is None else hw.to_payload()


def _loads(path, preset=PRESET, backend="modeled", **kw):
    """``(model payload, pairs)`` each package's store reads from ``path``;
    they must be equal."""
    out = {name: (_payload(core.CalibrationStore(path, **kw).load(preset, backend)),
                  core.CalibrationStore(path, **kw).load_pairs(preset, backend)) for name, core in PKGS.items()}
    assert plain(out["torch"]) == plain(out["jax"])
    return out["torch"]


def test_save_load_round_trip(store_path, tmp_path):
    store = tcore.CalibrationStore(store_path)
    assert store.load(PRESET, "modeled") is None
    assert store.load_pairs(PRESET, "modeled") == []
    hw = _refit()
    assert hw.to_payload() == _refit(jcore).to_payload()
    store.save(hw, PAIRS, preset=PRESET, backend="modeled")
    loaded = tcore.CalibrationStore(store_path).load(PRESET, "modeled")
    assert loaded is not None and loaded.name == hw.name
    m = 0.5 * hw.levels[0].capacity
    for t in (1, hw.thread_counts[-1]):
        assert loaded.l_atomic(t, m) == pytest.approx(hw.l_atomic(t, m))
    assert tcore.CalibrationStore(store_path).load_pairs(PRESET, "modeled") == PAIRS
    # the reference writes the same document
    jpath = str(tmp_path / "jax.json")
    jcore.CalibrationStore(jpath).save(_refit(jcore), PAIRS, preset=PRESET, backend="modeled")
    assert json.load(open(jpath)) == json.load(open(store_path))
    assert _loads(store_path) == _loads(jpath)


def test_engine_starts_on_persisted_refit(store_path):
    tcore.CalibrationStore(store_path).save(_refit(), PAIRS, preset=PRESET, backend="modeled")

    def scenario(alg, core, pkg):
        eng = core.MultiQueryEngine(core.XEON_E5_2660V4, policy="scheduler",
                                    calibration=core.CalibrationStore(store_path))
        eng2 = core.MultiQueryEngine(core.XEON_E5_2660V4, policy="scheduler", calibration=store_path)
        return eng.hw is not core.XEON_E5_2660V4, eng.hw.to_payload(), eng2.hw.name

    changed, payload, name2 = both(scenario)[0]
    assert changed and payload["name"] == f"{PRESET}+recal" and name2 == f"{PRESET}+recal"


def test_engine_without_matching_entry_starts_cold(store_path):
    tcore.CalibrationStore(store_path).save(_refit(), PAIRS, preset=PRESET, backend="cuda")
    jcore.CalibrationStore(store_path).save(_refit(jcore), PAIRS, preset=PRESET, backend="pallas")
    for core in PKGS.values():
        eng = core.MultiQueryEngine(core.XEON_E5_2660V4, calibration=core.CalibrationStore(store_path))
        assert eng.hw is core.XEON_E5_2660V4


def test_foreign_fingerprint_is_ignored(store_path):
    tcore.CalibrationStore(store_path, fingerprint="tpu-vm-c128").save(_refit(), PAIRS, preset=PRESET,
                                                                       backend="modeled")
    assert tcore.host_fingerprint() == jcore.host_fingerprint()
    assert tcore.CalibrationStore(store_path).fingerprint == tcore.host_fingerprint()
    assert _loads(store_path) == (None, [])
    assert _loads(store_path, fingerprint="tpu-vm-c128")[0] is not None


def test_wrong_backend_or_preset_is_ignored(store_path):
    tcore.CalibrationStore(store_path).save(_refit(), PAIRS, preset=PRESET, backend="inline")
    assert _loads(store_path, backend="pallas") == (None, [])
    assert _loads(store_path, backend="cuda") == (None, [])
    assert _loads(store_path, preset="tpu_v5e_pod", backend="inline") == (None, [])
    assert _loads(store_path, backend="inline")[0] is not None


def _edit(path, fn):
    doc = json.load(open(path))
    (key,) = doc["entries"]
    fn(doc["entries"][key])
    with open(path, "w") as f:
        json.dump(doc, f)


def test_stale_preset_version_is_ignored(store_path):
    tcore.CalibrationStore(store_path).save(_refit(), PAIRS, preset=PRESET, backend="modeled")
    _edit(store_path, lambda e: e.__setitem__("preset_version", tcore.PRESET_VERSION + 1))
    assert _loads(store_path)[0] is None


def test_tampered_key_fields_are_ignored(store_path):
    tcore.CalibrationStore(store_path).save(_refit(), PAIRS, preset=PRESET, backend="modeled")
    _edit(store_path, lambda e: e.__setitem__("backend", "inline"))
    assert _loads(store_path)[0] is None


def _warned(fn):
    """``fn()`` under recorded warnings: its result and the messages."""
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in got if issubclass(w.category, UserWarning)]


def test_corrupt_file_warns_and_starts_cold(store_path):
    with open(store_path, "w") as f:
        f.write("{definitely not json")
    msgs = {}
    for name, core in PKGS.items():
        store = core.CalibrationStore(store_path)
        out, msgs[name] = _warned(lambda: store.load(PRESET, "modeled"))
        assert out is None
        eng, w = _warned(lambda: core.MultiQueryEngine(core.XEON_E5_2660V4, calibration=store))
        assert eng.hw is core.XEON_E5_2660V4 and any("unreadable" in m for m in w)
    assert len(msgs["torch"]) == len(msgs["jax"]) == 1 and "unreadable" in msgs["torch"][0]
    store = tcore.CalibrationStore(store_path)
    with pytest.warns(UserWarning, match="unreadable"):
        store.save(_refit(), PAIRS, preset=PRESET, backend="modeled")
    assert _loads(store_path)[0] is not None


def test_wrong_schema_warns_and_starts_cold(store_path):
    with open(store_path, "w") as f:
        json.dump({"schema": 999, "entries": {}}, f)
    for core in PKGS.values():
        with pytest.warns(UserWarning, match="unknown shape"):
            assert core.CalibrationStore(store_path).load(PRESET, "modeled") is None


def test_malformed_model_payload_warns_and_is_ignored(store_path):
    tcore.CalibrationStore(store_path).save(_refit(), PAIRS, preset=PRESET, backend="modeled")
    _edit(store_path, lambda e: e.__setitem__("model", {"lat_atomic": "not-a-table"}))
    for core in PKGS.values():
        with pytest.warns(UserWarning, match="malformed"):
            assert core.CalibrationStore(store_path).load(PRESET, "modeled") is None


def test_malformed_pairs_poison_only_the_provenance(store_path):
    tcore.CalibrationStore(store_path).save(_refit(), PAIRS, preset=PRESET, backend="modeled")
    _edit(store_path, lambda e: e["pairs"].__setitem__(0, ["x", "y"]))
    model, pairs = _loads(store_path)
    assert pairs == [] and model is not None


def test_save_preserves_other_entries(store_path):
    tcore.CalibrationStore(store_path, fingerprint="host-a-c8").save(_refit(), PAIRS, preset=PRESET,
                                                                     backend="modeled")
    jcore.CalibrationStore(store_path, fingerprint="host-b-c2").save(_refit(jcore), PAIRS[:2], preset=PRESET,
                                                                     backend="inline")
    tcore.CalibrationStore(store_path, fingerprint="host-c-c4").save(_refit(), PAIRS[:3], preset=PRESET,
                                                                     backend="cuda")
    assert _loads(store_path, fingerprint="host-a-c8")[0] is not None
    assert _loads(store_path, fingerprint="host-b-c2", backend="inline")[1] == PAIRS[:2]
    assert _loads(store_path, fingerprint="host-c-c4", backend="cuda")[1] == PAIRS[:3]


# --------------------------------------------------- engine write-back

def _scaled_backend(core, factor=20.0):
    class ScaledBackend:
        """A 20x mis-scaled substrate named as the default one, so that store
        keys line up."""

        name = "modeled"

        def __init__(self):
            self._inner = core.ModeledBackend()

        def prepare(self, executor, prep):
            return self._inner.prepare(executor, prep)

        def execute(self, plan, step, modeled_ns=0.0):
            return self._inner.execute(plan, step, modeled_ns) * factor

    return ScaledBackend()


def _mixed_mk(alg, graph):
    hubs = np.argsort(-np.asarray(graph.out_degrees()))
    return lambda s, q: (alg.PageRankExecutor(graph, mode="pull", max_iters=3, tol=0) if s == 0
                         else alg.BFSExecutor(graph, int(hubs[s % 4])))


def _recalibrating_run(core, alg, graph, path):
    eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=8, policy="scheduler",
                                feedback=core.CostFeedback(), backend=_scaled_backend(core), calibration=path)
    cold = eng.hw is core.XEON_E5_2660V4
    eng.run_sessions(_mixed_mk(alg, graph), sessions=4, queries_per_session=1,
                     config=core.EngineConfig(width_feedback=True, recalibrate=True))
    return cold, eng.hw.to_payload()


def test_recalibrating_run_persists_refit_and_provenance(graphs, tmp_path):
    def scenario(alg, core, pkg):
        path = str(tmp_path / f"{pkg}.json")
        cold, hw = _recalibrating_run(core, alg, graphs[pkg], path)
        store = core.CalibrationStore(path)
        nxt = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=8, policy="scheduler",
                                    feedback=core.CostFeedback(), calibration=path)
        return cold, hw, _payload(store.load(PRESET, "modeled")), store.load_pairs(PRESET, "modeled"), nxt.hw.name

    cold, hw, persisted, pairs, next_name = both(scenario)[0]
    assert cold
    assert hw["name"] == f"{PRESET}+recal"
    assert persisted == hw
    assert pairs
    assert next_name == f"{PRESET}+recal"


def test_refit_trains_on_union_of_stored_and_fresh_pairs(graphs, tmp_path, monkeypatch):
    seeded = [(2, 7.0, 140.0), (4, 9.0, 180.0)]
    seen = {}
    import repro.core.session as jsession
    import repro_torch.core.session as tsession

    for pkg, mod, core in (("jax", jsession, jcore), ("torch", tsession, tcore)):
        real = core.recalibrate_preset

        def spy(hw, pairs, pkg=pkg, real=real, **kw):
            seen[pkg] = list(pairs)
            return real(hw, pairs, **kw)

        monkeypatch.setattr(mod, "recalibrate_preset", spy)

    def scenario(alg, core, pkg):
        path = str(tmp_path / f"{pkg}.json")
        core.CalibrationStore(path).save(_refit(core), seeded, preset=PRESET, backend="modeled")
        _recalibrating_run(core, alg, graphs[pkg], path)
        return core.CalibrationStore(path).load_pairs(PRESET, "modeled")

    stored, _ = both(scenario)
    assert plain(seen["torch"]) == plain(seen["jax"])
    assert seen["torch"][: len(seeded)] == seeded
    assert len(seen["torch"]) > len(seeded)
    assert stored == seen["torch"]


def test_payload_round_trip_and_from_payload_validation():
    from repro_torch.core import HardwareModel

    payload = tcore.XEON_E5_2660V4.to_payload()
    assert payload == jcore.XEON_E5_2660V4.to_payload()
    hw = HardwareModel.from_payload(payload)
    assert hw.name == tcore.XEON_E5_2660V4.name
    m = 0.5 * hw.levels[0].capacity
    assert hw.l_atomic(4, m) == pytest.approx(tcore.XEON_E5_2660V4.l_atomic(4, m))
    assert hw.to_payload() == jcore.HardwareModel.from_payload(payload).to_payload()
    with pytest.raises((KeyError, TypeError, ValueError)):
        HardwareModel.from_payload({"name": "broken"})
