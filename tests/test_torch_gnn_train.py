"""GNN training in the port against the JAX package on the CPU:
``launch.steps.gnn_train_step`` against the reference's own cell program
(``repro.launch.steps.make_gnn_cell``'s ``step_fn`` on concrete arrays) on
each smoke config and on GraphCast's owner-blocked layout, and
``examples/gnn_train.py``'s loop (MeshGraphNet on neighbour-sampled RMAT
batches) against the same loop in JAX on the same batches."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.tree_util import tree_flatten_with_path  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data import GraphBatchStream as JaxGraphBatchStream  # noqa: E402
from repro.graph import rmat_graph as jax_rmat_graph  # noqa: E402
from repro.launch.steps import make_gnn_cell  # noqa: E402
from repro.models.gnn import meshgraphnet as jmgn  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import GraphBatchStream  # noqa: E402
from repro_torch.graph import rmat_graph  # noqa: E402
from repro_torch.launch.steps import gnn_train_step  # noqa: E402
from repro_torch.models.gnn import meshgraphnet as mgn  # noqa: E402
from repro_torch.models.gnn.common import params_tree  # noqa: E402

from _torch_bench_rows import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread a test)
from _torch_gnn import blocked_batch, port_model, port_module, smoke_batch, to_torch  # noqa: E402

# a step's loss and gradient norm: float32 sums in another order
STEP_RTOL = 1e-5
# weights after steps of lr 1e-3: AdamW moves each by at most ~lr a step
# (the optimizers are held equal in tests/test_torch_train.py), so the
# gradients' float32 differences leave the weights within 1e-6
PARAM_ATOL = 1e-6
# PNA's float32 gradients carry noise of up to ~1e-3 of a leaf's largest
# entry in both packages (tests/test_torch_gnn.py holds each against
# float64), so its steps are held to what that noise moves: AdamW's update
# of an element whose gradient is near eps moves by up to lr times its
# relative noise
PNA_PARAM_ATOL, PNA_MOMENT_REL = 1e-5, 2e-3
# AdamW's eps in the step tests, raised from 1e-8: under the default an
# element whose gradient is within float32 noise of eps moves by up to lr
# times its relative noise, which left single PNA and SchNet weights 3e-6
# apart after one step (tests/test_torch_train.py found the same)
STEP_EPS = 1e-4
# the example's loop, at the example's own eps (1e-8): 20 steps of lr 1e-3
# (warmup 5, decay 100), its losses within float32 drift of the
# reference's (1.5e-6 measured here)
LOOP_RTOL = 1e-5

# the reference's configs' make_cell arguments per arch, at a shape whose
# graph count the step sets (molecule: 128 graphs; the rest one)
CELL_ARGS = {
    "meshgraphnet": ("full_graph_sm", dict(d_edge=8, d_target=3)),
    "graphcast": ("full_graph_sm", dict(d_edge=4, d_target=16)),
    "pna": ("full_graph_sm", dict(d_edge=1, d_target=1, int_targets=True)),
    "schnet": ("molecule", dict(d_edge=1, d_target=1, with_positions=True, per_graph_target=True)),
}
CASES = [("meshgraphnet", False), ("graphcast", False), ("graphcast", True), ("pna", False), ("schnet", False)]


def _paths(tree) -> list[str]:
    return [jax.tree_util.keystr(p) for p, _ in tree_flatten_with_path(tree)[0]]


def _assert_tree_close(got, want, rtol, atol):
    for path, g, w in zip(_paths(want), tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=rtol, atol=atol, err_msg=path)


@pytest.mark.parametrize("arch,blocked", CASES, ids=[f"{a}{'-blocked' if b else ''}" for a, b in CASES])
def test_gnn_train_step_matches_the_reference_cell(arch, blocked):
    jcfg, cfg = jax_get_arch(arch).make_smoke_config(), get_arch(arch).make_smoke_config()
    jmod = importlib.import_module(f"repro.models.gnn.{arch}")
    shape, kw = CELL_ARGS[arch]
    jopt = joptim.OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=1, decay_steps=10, eps=STEP_EPS)
    cell = make_gnn_cell(arch, jmod, jcfg, shape, jopt, blocked=blocked, **kw)
    n_graphs = 128 if arch == "schnet" else 1
    rng = np.random.default_rng(11)
    batch = blocked_batch(rng, cfg) if blocked else smoke_batch(arch, cfg, rng)
    if arch == "schnet":
        batch["targets"] = rng.normal(size=(n_graphs,)).astype(np.float32)
    batch.pop("n_graphs")

    params = jax.tree.map(np.asarray, jax.jit(lambda k: jmod.init_params(jcfg, k))(jax.random.PRNGKey(1)))
    init_opt, _ = joptim.make_optimizer(jopt)
    jstate = init_opt(params)
    model = port_model(arch, cfg, port_module(arch).params_from_jax(cfg, params))
    opt = optim.OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=1, decay_steps=10, eps=STEP_EPS)
    state = optim.adamw_init(params_tree(model))
    step = gnn_train_step(port_module(arch), cfg, opt, n_graphs=n_graphs, blocked=blocked)
    jstep = jax.jit(cell.step_fn)
    jp, tb = params, to_torch(batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        jp, jstate, want = jstep(jp, jstate, jb)
        model, state, got = step(model, state, tb)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=STEP_RTOL)
        np.testing.assert_allclose(float(got["gnorm"]), float(want["gnorm"]), rtol=STEP_RTOL)
        _assert_tree_close(params_tree(model), jp, 0, PNA_PARAM_ATOL if arch == "pna" else PARAM_ATOL)
    assert int(state["step"]) == int(jstate["step"]) == 2
    # the moments, within the gradients' float32 noise (each leaf's scale)
    for part in ("mu", "nu"):
        for path, g, w in zip(_paths(jstate[part]), tree_leaves(state[part]), jax.tree.leaves(jstate[part])):
            w = np.asarray(w)
            rel = PNA_MOMENT_REL if arch == "pna" else 1e-4
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=rel * float(np.abs(w).max()) + 1e-12,
                                       err_msg=f"{part} {path}")


def _loop_batch(raw: dict, targets_of, ones) -> dict:
    """The example's batch from a GraphBatchStream step: node features
    ``feats``, edge features all ones, one graph, targets 0.5 × the first
    three feature columns."""
    n, e = raw["nodes"].shape[0], raw["src"].shape[0]
    return dict(nodes=raw["feats"], src=raw["src"], dst=raw["dst"], edge_feat=ones((e, 8)),
                node_mask=raw["node_mask"], edge_mask=raw["edge_mask"], graph_ids=ones((n,)) * 0,
                n_graphs=1, targets=targets_of(raw["feats"]))


def test_example_loop_matches_jax():
    """``examples/gnn_train.py``'s loop (MeshGraphNet, 4 layers of 64, on
    ``rmat_graph(11, seed=1)`` through ``GraphBatchStream(batch_nodes=32,
    fanouts=(6, 4), d_feat=16)``; AdamW lr 1e-3, warmup 5, decay 100, clip
    1.0) for 20 steps in both packages: the same losses."""
    steps = 20
    jcfg = jmgn.MGNConfig(n_layers=4, d_hidden=64, d_node_in=16, d_edge_in=8, d_out=3)
    cfg = mgn.MGNConfig(n_layers=4, d_hidden=64, d_node_in=16, d_edge_in=8, d_out=3)
    kw = dict(name="adamw", lr=1e-3, warmup_steps=5, decay_steps=100)
    jopt, opt = joptim.OptimizerConfig(**kw), optim.OptimizerConfig(**kw)

    params = jax.jit(lambda k: jmgn.init_params(jcfg, k))(jax.random.PRNGKey(0))
    model = mgn.MeshGraphNet(cfg, device="cpu")
    model.load_state_dict(mgn.params_from_jax(cfg, jax.tree.map(np.asarray, params)))
    init_opt, update = joptim.make_optimizer(jopt)
    jstate, state = init_opt(params), optim.adamw_init(params_tree(model))

    @jax.jit
    def jstep(params, opt_state, batch):
        loss, grads = jax.value_and_grad(lambda p: jmgn.loss_fn(jcfg, p, batch))(params)
        grads, _ = joptim.clip_by_global_norm(grads, 1.0)
        params, opt_state = update(jopt, grads, opt_state, params)
        return params, opt_state, loss

    step = gnn_train_step(mgn, cfg, opt, n_graphs=1)
    jstream = JaxGraphBatchStream(jax_rmat_graph(11, seed=1), batch_nodes=32, fanouts=(6, 4), d_feat=16)
    stream = GraphBatchStream(rmat_graph(11, seed=1, device="cpu"), batch_nodes=32, fanouts=(6, 4), d_feat=16,
                              device="cpu")
    want, got = [], []
    for _ in range(steps):
        jraw, raw = next(jstream), next(stream)
        np.testing.assert_array_equal(raw["src"].numpy(), np.asarray(jraw["src"]))
        np.testing.assert_array_equal(raw["feats"].numpy(), jraw["feats"])
        jb = _loop_batch(jraw, lambda f: jnp.asarray(f[:, :3] * 0.5), lambda s: jnp.ones(s, jnp.float32))
        jb["nodes"] = jnp.asarray(jb["nodes"])
        jb.pop("n_graphs")
        params, jstate, loss = jstep(params, jstate, jb)
        want.append(float(loss))
        tb = _loop_batch(raw, lambda f: f[:, :3] * 0.5, lambda s: torch.ones(s))
        model, state, m = step(model, state, tb)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=LOOP_RTOL)
    assert got[-1] < got[0]
