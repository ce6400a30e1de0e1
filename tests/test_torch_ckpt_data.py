"""The port's checkpoints, data streams and trainer against the JAX package
on the CPU: ports of ``tests/test_substrates.py``'s checkpoint, stream and
restart tests; every stream's arrays equal to the reference's; checkpoints
written by either package restored by the other; a training run stopped in
one package and resumed in the other; the launcher."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import port_graph  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro.ckpt import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch.train import train_lm as jax_train_lm  # noqa: E402
from repro_torch import data  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402

# a run resumed in the other package against that package's uninterrupted
# run: the same float32 steps up to summation order, so the losses agree to
# float32 noise; AdamW may step an element whose gradient lies within that
# noise of zero either way (tests/test_torch_train.py), which moves a loss
# by far less than this
CROSS_LOSS_RTOL = 1e-5
# the reference's own restart tolerance (tests/test_substrates.py)
RESTART_RTOL, RESTART_ATOL = 2e-4, 2e-5


# ---------------- checkpoint ----------------

def test_checkpoint_roundtrip_and_prune(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"a": torch.arange(12.0).reshape(3, 4), "n": {"b": torch.ones(5, dtype=torch.int32)}}
    for step in (1, 2, 3):
        mgr.save(step, {"a": tree["a"] * step, "n": {"b": tree["n"]["b"] * step}})
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    back = mgr.restore(tree)
    assert np.allclose(back["a"], tree["a"].numpy() * 3)
    assert back["n"]["b"].dtype == np.int32 and back["n"]["b"].tolist() == [3] * 5


def test_checkpoint_save_copies_before_returning(tmp_path):
    """The caller may overwrite its tensors (the trainer does, in place)
    while the writer thread is still at work."""
    mgr = CheckpointManager(tmp_path)
    t = torch.zeros(1000)
    mgr.save(1, {"t": t})
    t.fill_(7.0)
    mgr.wait()
    assert float(mgr.restore({"t": t})["t"].max()) == 0.0


def test_checkpoint_torn_write_not_loadable(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, async_write=False)
    mgr.save(7, {"a": torch.ones(3)})
    # simulate a torn write: step dir without manifest
    torn = tmp_path / "step_000000008"
    torn.mkdir()
    (torn / "a00000.npy").write_bytes(b"garbage")
    assert mgr.latest_step() == 7  # torn dir ignored


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(1, {"a": torch.ones(3)})
    with pytest.raises(ValueError):
        mgr.restore({"a": torch.ones(4)})
    with pytest.raises(KeyError):
        mgr.restore({"b": torch.ones(3)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore({"a": torch.ones(3)})


def _tree(rng):
    return {"params": {"w": rng.normal(size=(2, 3, 4)).astype(np.float32),
                       "embed": rng.normal(size=(5, 3)).astype(np.float32)},
            "opt": {"mu": {"w": rng.normal(size=(2, 3, 4)).astype(np.float32)}, "step": np.int32(9)}}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_restore_across_packages(tmp_path, writer):
    tree = _tree(np.random.default_rng(0))
    if writer == "jax":
        JaxCheckpointManager(tmp_path, async_write=False).save(4, jax.tree.map(jnp.asarray, tree))
        back = CheckpointManager(tmp_path).restore(tree)
    else:
        as_tensors = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
        CheckpointManager(tmp_path, async_write=False).save(4, as_tensors)
        back = JaxCheckpointManager(tmp_path).restore(jax.tree.map(jnp.asarray, tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    manifest = json.loads((tmp_path / "step_000000004" / "MANIFEST.json").read_text())
    assert sorted(manifest["arrays"]) == ["opt/mu/w", "opt/step", "params/embed", "params/w"]
    assert [manifest["arrays"][k]["file"] for k in sorted(manifest["arrays"])] == [f"a{i:05d}.npy" for i in range(4)]


# ---------------- data ----------------

def test_token_stream_deterministic_resume():
    s1 = data.TokenStream(1000, 2, 8)
    batches = [next(s1) for _ in range(3)]
    s2 = data.TokenStream.from_state(1000, 2, 8, {"seed": 0, "step": 2})
    np.testing.assert_array_equal(next(s2)["tokens"], batches[2]["tokens"])
    assert s2.state() == {"seed": 0, "step": 3}


@pytest.mark.parametrize("seed,start", [(0, 0), (5, 17)])
def test_token_stream_equals_the_reference(seed, start):
    mine = data.TokenStream(32000, 3, 40, seed=seed, step=start)
    ref = jdata.TokenStream(32000, 3, 40, seed=seed, step=start)
    for _ in range(3):
        a, b = next(mine), next(ref)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_interaction_stream_logq():
    b = next(data.InteractionStream(1000, 500, 64))
    assert b["user"]["user_id"].shape == (64, 1)
    assert np.isfinite(b["log_q"]).all()


def test_interaction_stream_equals_the_reference():
    mine, ref = data.InteractionStream(1000, 500, 64, seed=3), jdata.InteractionStream(1000, 500, 64, seed=3)
    for _ in range(2):
        for a, b in zip(jax.tree.leaves(next(mine)), jax.tree.leaves(next(ref))):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_graph_batch_stream_equals_the_reference(small_rmat):
    mine = data.GraphBatchStream(port_graph(small_rmat), batch_nodes=16, fanouts=(4, 3), d_feat=8, device="cpu")
    ref = jdata.GraphBatchStream(small_rmat, batch_nodes=16, fanouts=(4, 3), d_feat=8)
    for _ in range(2):
        a, b = next(mine), next(ref)
        assert a["src"].shape == a["dst"].shape and a["feats"].shape[1] == 8
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


def test_graph_batch_stream_defaults_to_the_card(small_rmat, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = data.GraphBatchStream(port_graph(small_rmat), batch_nodes=4, fanouts=(2,), d_feat=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(s)


# ---------------- the trainer ----------------

def _smoke():
    return get_arch("tinyllama-1.1b").make_smoke_config()


def test_train_restart_resumes(tmp_path):
    """Kill/restart contract: resuming reproduces the uninterrupted run."""
    cfg = _smoke()
    kw = dict(steps=8, batch=2, seq=16, ckpt_every=4, device="cpu")
    full = train.train_lm(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    # preempted run: killed after 4 steps (same schedule), then resumed to 8
    train.train_lm(cfg, ckpt_dir=str(tmp_path / "b"), stop_after=4, **kw)
    resumed = train.train_lm(cfg, ckpt_dir=str(tmp_path / "b"), resume=True, **kw)
    for a, b in zip(tree_leaves(full["params"]), tree_leaves(resumed["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RESTART_RTOL, atol=RESTART_ATOL)
    assert CheckpointManager(tmp_path / "b").all_steps() == [4, 8]
    assert [s for s, _ in resumed["losses"]] == [7]  # logged every 10 steps and the last


def _losses(out) -> dict:
    return {s: loss for s, loss in out["losses"]}


@pytest.mark.parametrize("first", ["jax", "port"])
def test_training_resumes_across_packages(tmp_path, first):
    """One package trains 4 of 8 steps and stops; the other resumes from its
    checkpoint (weights, AdamW moments, step, the stream's cursor) and
    finishes steps 4-7, with the losses of the first package's
    uninterrupted run."""
    jcfg, cfg = jax_get_arch("tinyllama-1.1b").make_smoke_config(), _smoke()
    kw = dict(steps=8, batch=2, seq=24, ckpt_every=4, log_every=1)
    runs = {"jax": lambda **k: jax_train_lm(jcfg, **kw, **k),
            "port": lambda **k: train.train_lm(cfg, device="cpu", **kw, **k)}
    second = "port" if first == "jax" else "jax"
    full = runs[first](ckpt_dir=str(tmp_path / "full"))
    runs[first](ckpt_dir=str(tmp_path / "cut"), stop_after=4)
    resumed = runs[second](ckpt_dir=str(tmp_path / "cut"), resume=True)
    want, got = _losses(full), _losses(resumed)
    assert sorted(got) == [4, 5, 6, 7]
    np.testing.assert_allclose([got[s] for s in got], [want[s] for s in got], rtol=CROSS_LOSS_RTOL)
    assert want[7] < want[0]


def test_train_lm_refuses_cpu_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train_lm(_smoke(), steps=1, batch=1, seq=8)


def test_train_launcher_runs_on_cpu(tmp_path, capsys):
    out = train.main(["--device", "cpu", "--steps", "8", "--ckpt-dir", str(tmp_path)])
    assert [s for s, _ in out["losses"]] == [0, 7]
    assert out["losses"][-1][1] < out["losses"][0][1]
    assert "done: loss" in capsys.readouterr().out
    assert CheckpointManager(tmp_path).all_steps() == [8]
    assert isinstance(out["model"], tf.TransformerLM)
