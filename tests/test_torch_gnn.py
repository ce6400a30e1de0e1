"""The port's GNN family against the JAX package on the CPU, on the same
numpy inputs and weights: ``aggregate`` (all four modes, the out-of-range
drop, non-finite maxima, tie gradients), the masked losses, the MLP's
activation, PNA's std at its tie, SchNet's radial basis and softplus,
GraphCast's multimesh, the four smoke configs' forward, loss and every
gradient leaf (``tests/test_arch_smoke.py::test_gnn_smoke_forward_and_grad``'s
counterpart), GraphCast's owner-blocked path, the parameter trees, the
configs, ``GNN_SHAPES`` and the registry."""
import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.tree_util import tree_flatten_with_path  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.gnn import common as jcommon  # noqa: E402
from repro.models.gnn import graphcast as jgraphcast  # noqa: E402
from repro.models.gnn import pna as jpna  # noqa: E402
from repro.models.gnn import schnet as jschnet  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map, tree_paths  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_arch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.gnn import common, graphcast, pna, schnet  # noqa: E402
from repro_torch.models.gnn.common import params_tree  # noqa: E402

from _torch_bench_rows import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread a test)
from _torch_gnn import (  # noqa: E402
    GNN_ARCHS, blocked_batch, flat_edges, port_model, port_module, smoke_batch, to_torch,
)

# float32 forward and loss: the same math, the products blocked and the
# scatters' sums ordered differently
RTOL, ATOL = 1e-5, 1e-6
# gradients per leaf: the backward's sums also reordered
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# PNA is ill-conditioned in float32 at the smoke batch (the one-pass
# variance cancels; the attenuation scaler is 250,000 at a node with no
# in-edge): against a float64 run of the same weights, both packages'
# float32 gradients stray by up to ~1e-3 of a leaf's largest entry (1.0e-3
# at most over seeds 0-7), and their outputs by ~3e-6 of the largest
# output. So PNA's leaves are held to float64 within PNA_GRAD_REL of their
# largest entry, the reference's too (the bar is its own noise), and its
# outputs to the reference's within PNA_OUT_REL of the largest
PNA_GRAD_REL, PNA_OUT_REL = 2e-3, 1e-5


def _assert_out_close(got, want):
    """A model's outputs: an output near 0 is a float32 sum of terms as
    large as the largest output, so the absolute allowance scales with it."""
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(want).max())))


def _np(x) -> np.ndarray:
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _jax_batch(b: dict) -> dict:
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in b.items()}


def _paths(tree) -> list[str]:
    return [jax.tree_util.keystr(p) for p, _ in tree_flatten_with_path(tree)[0]]


def _ids(rng, e: int, n: int) -> np.ndarray:
    """Segment ids in [0, n) with out-of-range ones planted: -1, n, n + 3."""
    ids = rng.integers(0, n, e).astype(np.int32)
    ids[[1, 4, 7]] = [-1, n, n + 3]
    return ids


# ---------------- aggregate ----------------

# the reference's mean divides by an [N, 1] count: 2-d messages only
@pytest.mark.parametrize("how,shape", [("sum", (40, 6)), ("mean", (40, 6)), ("max", (40, 6)), ("min", (40, 6)),
                                       ("sum", (40,)), ("max", (40,)), ("min", (40,))])
def test_aggregate_matches_jax(how, shape):
    rng = np.random.default_rng(1)
    n = 13  # 40 ids over 13 rows: some rows receive nothing
    msg = rng.normal(size=shape).astype(np.float32)
    ids = _ids(rng, shape[0], n)
    ids[ids == 5] = 6  # row 5 is empty
    want = np.asarray(jcommon.aggregate(jnp.asarray(msg), jnp.asarray(ids), n, how))
    got = common.aggregate(torch.from_numpy(msg), torch.from_numpy(ids), n, how)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert not got[5].any()


def test_segment_sum_drops_out_of_range_ids_as_jax_does():
    msg = np.array([1.0, 2.0, 2.0, 7.0, 11.0, 13.0], np.float32)
    ids = np.array([0, 0, 0, 1, -1, 3], np.int32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(msg), jnp.asarray(ids), num_segments=3))
    got = common.aggregate(torch.from_numpy(msg), torch.from_numpy(ids), 3, "sum")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [5.0, 7.0, 0.0])
    with pytest.raises((IndexError, RuntimeError)):  # what the drop replaces
        torch.zeros(3).index_add(0, torch.from_numpy(ids).long(), torch.from_numpy(msg))


@pytest.mark.parametrize("how", ["max", "min"])
def test_aggregate_non_finite_extremes_become_zero(how):
    inf, nan = np.inf, np.nan
    msg = np.array([[1.0], [inf], [2.0], [-inf], [nan], [3.0], [-2.0], [5.0]], np.float32)
    ids = np.array([0, 0, 1, 1, 2, 2, 4, -1], np.int32)  # row 3 empty; the 5.0 dropped
    want = np.asarray(jcommon.aggregate(jnp.asarray(msg), jnp.asarray(ids), 5, how))
    got = common.aggregate(torch.from_numpy(msg), torch.from_numpy(ids), 5, how)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isfinite(want).all() and want[3, 0] == 0


@pytest.mark.parametrize("how", ["max", "min"])
def test_aggregate_tie_gradients_match_jax(how):
    """Equal extremes share the gradient evenly in both packages."""
    msg = np.array([[1.0, 4.0], [2.0, 4.0], [2.0, 0.0], [3.0, 1.0], [3.0, 1.0], [3.0, 9.0]], np.float32)
    ids = np.array([0, 0, 0, 1, 1, 1], np.int32)
    cot = np.array([[1.0, 2.0], [3.0, 5.0]], np.float32)
    _, vjp = jax.vjp(lambda m: jcommon.aggregate(m, jnp.asarray(ids), 2, how), jnp.asarray(msg))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    t = torch.tensor(msg, requires_grad=True)
    common.aggregate(t, torch.from_numpy(ids), 2, how).backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(t.grad.numpy(), want)
    if how == "max":  # rows 1 and 2 tie for segment 0's first column, rows 3-5 for segment 1's second
        assert want[1, 0] == want[2, 0] == 0.5 * cot[0, 0] and want[0, 0] == 0
        assert want[3, 1] == want[4, 1] == 0 and want[5, 1] == cot[1, 1]


@pytest.mark.parametrize("how", ["sum", "mean", "max", "min"])
def test_aggregate_gradients_match_jax(how):
    rng = np.random.default_rng(2)
    msg = rng.normal(size=(50, 5)).astype(np.float32)
    ids = _ids(rng, 50, 9)
    cot = rng.normal(size=(9, 5)).astype(np.float32)
    _, vjp = jax.vjp(lambda m: jcommon.aggregate(m, jnp.asarray(ids), 9, how), jnp.asarray(msg))
    t = torch.tensor(msg, requires_grad=True)
    common.aggregate(t, torch.from_numpy(ids), 9, how).backward(torch.from_numpy(cot))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), rtol=RTOL, atol=ATOL)


# ---------------- losses and the MLP ----------------

def test_masked_mse_matches_jax():
    rng = np.random.default_rng(3)
    pred, target = (rng.normal(size=(20, 3)).astype(np.float32) for _ in range(2))
    mask = (rng.random(20) < 0.6).astype(np.float32)
    for m in (mask, np.zeros_like(mask)):  # an all-masked batch divides by 1
        want = float(jcommon.masked_mse(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(m)))
        got = float(common.masked_mse(torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(m)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_masked_ce_and_its_gradient_match_jax():
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(30, 7)) * 4).astype(np.float32)
    labels = rng.integers(0, 7, 30).astype(np.int32)
    mask = (rng.random(30) < 0.7).astype(np.float32)
    want, jg = jax.value_and_grad(lambda x: jcommon.masked_ce(x, jnp.asarray(labels), jnp.asarray(mask)))(
        jnp.asarray(logits))
    t = torch.tensor(logits, requires_grad=True)
    got = common.masked_ce(t, torch.from_numpy(labels), torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    with pytest.raises((IndexError, RuntimeError)):  # a label past the classes: invalid input
        common.masked_ce(t, torch.full((30,), 7, dtype=torch.int32), torch.from_numpy(mask))


@pytest.mark.parametrize("act", ["relu", "shifted_softplus"])
@pytest.mark.parametrize("layernorm", [True, False])
def test_mlp_activation_matches_jax(act, layernorm):
    sizes = [9, 16, 16, 5]
    jact = jax.nn.relu if act == "relu" else jschnet.shifted_softplus
    tact = {} if act == "relu" else {"activation": schnet.shifted_softplus}
    tree = jax.tree.map(np.asarray, jcommon.mlp_init(jax.random.PRNGKey(3), sizes, layernorm=layernorm))
    x = np.random.default_rng(5).normal(size=(11, 9)).astype(np.float32) * 3
    want = np.asarray(jcommon.mlp_apply(tree, jnp.asarray(x), activation=jact))
    mlp = common.MLP(sizes, layernorm=layernorm, device="cpu", **tact)
    mlp.load_state_dict(common.mlp_state_from_jax(tree))
    np.testing.assert_allclose(mlp(torch.from_numpy(x)).detach().numpy(), want, rtol=RTOL, atol=ATOL)
    if act == "relu":  # the default stays ReLU
        assert mlp.activation is torch.nn.functional.relu


# ---------------- PNA's std, SchNet's basis, GraphCast's multimesh ----------------

def _jax_std_from_moments(mean, mean_sq):  # src/repro/models/gnn/pna.py:59
    return jnp.sqrt(jnp.maximum(mean_sq - mean**2, 0.0) + jpna.EPS)


def test_pna_std_gradient_at_its_tie_matches_jax():
    """Nodes of in-degree 0 and 1 have a variance of exactly 0: jnp.maximum
    and torch.maximum pass half the gradient to each side there."""
    rng = np.random.default_rng(6)
    msg = rng.normal(size=(9, 4)).astype(np.float32)
    dst = np.array([1, 2, 2, 3, 3, 3, 5, 5, 5], np.int32)  # degrees 0, 1, 2, 3, 0, 3
    n = 6
    mean = np.asarray(jcommon.aggregate(jnp.asarray(msg), jnp.asarray(dst), n, "mean"))
    mean_sq = np.asarray(jcommon.aggregate(jnp.asarray(msg * msg), jnp.asarray(dst), n, "mean"))
    assert (mean_sq - mean**2)[[0, 1, 4]].tolist() == [[0.0] * 4] * 3  # the tie
    cot = rng.normal(size=(n, 4)).astype(np.float32)

    want, vjp = jax.vjp(_jax_std_from_moments, jnp.asarray(mean), jnp.asarray(mean_sq))
    w_mean, w_sq = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    m = torch.tensor(mean, requires_grad=True)
    s = torch.tensor(mean_sq, requires_grad=True)
    got = pna._std_from_moments(m, s)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(m.grad.numpy(), w_mean, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(s.grad.numpy(), w_sq, rtol=GRAD_RTOL, atol=GRAD_ATOL)

    # companion: clamp_min passes the whole gradient at the tie, so it differs there
    m2 = torch.tensor(mean, requires_grad=True)
    s2 = torch.tensor(mean_sq, requires_grad=True)
    torch.sqrt(torch.clamp_min(s2 - m2**2, 0.0) + pna.EPS).backward(torch.from_numpy(cot))
    np.testing.assert_allclose(s2.grad.numpy()[[2, 3, 5]], w_sq[[2, 3, 5]], rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(s2.grad.numpy()[[0, 1, 4]], 2 * w_sq[[0, 1, 4]], rtol=GRAD_RTOL)
    assert not np.allclose(s2.grad.numpy()[[0, 1, 4]], w_sq[[0, 1, 4]], rtol=GRAD_RTOL, atol=GRAD_ATOL)

    # and the whole aggregator, values and gradient through the messages
    want, vjp = jax.vjp(lambda x: jpna._std_aggregate(x, jnp.asarray(dst), n), jnp.asarray(msg))
    t = torch.tensor(msg, requires_grad=True)
    got = pna._std_aggregate(t, torch.from_numpy(dst), n)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("n_rbf,cutoff", [(20, 10.0), (300, 10.0), (7, 3.3)])
def test_rbf_expand_matches_jax(n_rbf, cutoff):
    dist = np.abs(np.random.default_rng(7).normal(size=64) * cutoff / 2).astype(np.float32)
    want = np.asarray(jschnet.rbf_expand(jnp.asarray(dist), n_rbf, cutoff))
    got = schnet.rbf_expand(torch.from_numpy(dist), n_rbf, cutoff)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the centers equal jnp.linspace's in bits (a distance on a center gives 1)
    centers = np.asarray(jnp.linspace(0.0, cutoff, n_rbf))
    np.testing.assert_array_equal(schnet.rbf_expand(torch.from_numpy(centers), n_rbf, cutoff).diagonal().numpy(),
                                  np.ones(n_rbf, np.float32))


def test_shifted_softplus_and_its_gradient_match_jax():
    x = np.concatenate([np.linspace(-40, 40, 401), [0.0, 1e-8, -1e-8, 20.0, 25.0]]).astype(np.float32)
    want, jg = jax.value_and_grad(lambda v: jschnet.shifted_softplus(v).sum())(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    got = schnet.shifted_softplus(t)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jschnet.shifted_softplus(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("refinement", [0, 1, 2, 3])
def test_multimesh_edges_equal_jax(refinement):
    want = jgraphcast.multimesh_edges(refinement)
    got = graphcast.multimesh_edges(refinement)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ---------------- the smoke configs end to end ----------------

@functools.cache
def _jax_smoke_params(arch: str, seed: int) -> dict:
    """The reference's smoke-config weights as numpy arrays (one init per
    arch, jitted: its eager vmap of key splits takes seconds)."""
    jcfg = jax_get_arch(arch).make_smoke_config()
    jmod = importlib.import_module(f"repro.models.gnn.{arch}")
    return jax.tree.map(np.asarray, jax.jit(lambda k: jmod.init_params(jcfg, k))(jax.random.PRNGKey(seed)))


def _smoke_case(arch: str, seed: int = 0):
    """The reference's and the port's smoke config, the reference's weights
    (numpy), the batch, and the port's model holding those weights."""
    jcfg, cfg = jax_get_arch(arch).make_smoke_config(), get_arch(arch).make_smoke_config()
    jmod = importlib.import_module(f"repro.models.gnn.{arch}")
    params = _jax_smoke_params(arch, seed)
    batch = smoke_batch(arch, cfg, np.random.default_rng(seed))
    model = port_model(arch, cfg, port_module(arch).params_from_jax(cfg, params))
    return jcfg, cfg, jmod, params, batch, model


def _assert_grads_close(got_tree, want_tree, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    got = tree_leaves(got_tree)
    want = jax.tree.leaves(want_tree)
    assert [p for p, _ in tree_paths(got_tree)] and len(got) == len(want)
    for path, g, w in zip(_paths(want_tree), got, want):
        assert tuple(g.shape) == np.shape(w), path
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=rtol, atol=atol, err_msg=path)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_smoke_config_forward_loss_and_grads_match_jax(arch):
    jcfg, cfg, jmod, params, batch, model = _smoke_case(arch)
    jb = _jax_batch(batch)
    want_out, (want_loss, want_grads) = jax.jit(lambda p: (
        jmod.forward(jcfg, p, jb), jax.value_and_grad(lambda q: jmod.loss_fn(jcfg, q, jb))(p)))(params)
    mod = port_module(arch)
    tb = to_torch(batch)
    out = mod.forward(cfg, model, tb)
    loss = mod.loss_fn(cfg, model, tb)
    loss.backward()
    grads = params_tree(model, grads=True)
    assert np.isfinite(float(loss)) and all(torch.isfinite(g).all() for g in tree_leaves(grads))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL, atol=ATOL)
    if arch != "pna":
        _assert_out_close(out, want_out)
        _assert_grads_close(grads, want_grads)
        return
    np.testing.assert_allclose(_np(out), want_out, rtol=0, atol=PNA_OUT_REL * np.abs(want_out).max())
    # each gradient leaf within float32's noise of a float64 run, as the reference's is
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    model64 = port_model(arch, cfg64, pna.params_from_jax(cfg64, params))
    pna.loss_fn(cfg64, model64, dict(tb, nodes=tb["nodes"].double())).backward()
    exact = tree_leaves(params_tree(model64, grads=True))
    for path, g, w, x in zip(_paths(want_grads), tree_leaves(grads), jax.tree.leaves(want_grads), exact):
        bar = PNA_GRAD_REL * float(x.abs().max()) + GRAD_ATOL
        assert float((torch.from_numpy(np.asarray(w, np.float64)) - x).abs().max()) <= bar, path
        assert float((g.double() - x).abs().max()) <= bar, path


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_params_tree_is_the_reference_tree(arch):
    """``params_from_jax`` then ``params_tree`` gives back the reference's
    tree: the same paths, shapes and numbers (layers stacked again)."""
    *_, params, _, model = _smoke_case(arch)
    tree = params_tree(model)
    assert _paths(tree_map(_np, tree)) == _paths(params)
    for g, w in zip(tree_leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(_np(g), w)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_models_build_on_the_card_unless_told_otherwise(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch(arch).make_smoke_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_model(arch, cfg, device=None)
    assert next(port_model(arch, cfg).parameters()).device.type == "cpu"


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gathers_outside_the_table_raise(arch):
    """An id outside ``[0, n)`` is invalid input: the reference's gathers
    wrap -1 and clamp or fill NaN past the end; the port's raise. Atom
    types (SchNet) and edge ends (the others) are each tried at -1 and n."""
    jcfg, cfg, jmod, params, batch, model = _smoke_case(arch)
    key, n = ("nodes", cfg.n_atom_types) if arch == "schnet" else ("src", batch["nodes"].shape[0])
    for bad in (-1, n):
        b = {k: v.copy() if isinstance(v, np.ndarray) else v for k, v in batch.items()}
        b[key][3] = bad
        assert np.asarray(jmod.forward(jcfg, params, _jax_batch(b))).shape  # the reference runs on
        with pytest.raises((IndexError, RuntimeError)):
            port_module(arch).forward(cfg, model, to_torch(b))


# ---------------- GraphCast's owner-blocked path ----------------

def test_graphcast_blocked_matches_jax_and_the_flat_path():
    jcfg, cfg, _, params, _, model = _smoke_case("graphcast")
    batch = blocked_batch(np.random.default_rng(8), cfg)
    jb = _jax_batch(batch)
    want_out, (want_loss, want_grads) = jax.jit(lambda p: (
        jgraphcast.forward_blocked(jcfg, p, jb),
        jax.value_and_grad(lambda q: jgraphcast.loss_fn_blocked(jcfg, q, jb))(p)))(params)
    tb = to_torch(batch)
    out = graphcast.forward_blocked(cfg, model, tb)
    loss = graphcast.loss_fn_blocked(cfg, model, tb)
    loss.backward()
    _assert_out_close(out, want_out)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL, atol=ATOL)
    _assert_grads_close(params_tree(model, grads=True), want_grads)
    # the same edges as one flat list: the same loss, up to the sums' order
    flat = graphcast.loss_fn(cfg, model, to_torch(flat_edges(batch)))
    np.testing.assert_allclose(float(flat), float(loss), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bad", [12, 13, 30, -1, -13], ids=["npb", "npb+1", "far", "minus1", "below"])
def test_graphcast_blocked_drops_out_of_range_dst_local_within_its_block(bad):
    """A valid edge whose ``dst_local`` lies outside its block's ``N/P``
    rows adds nothing (the reference's batched segment sum drops it within
    its block); the flat index ``p * N/P + dst_local`` would spill it into
    the next block. The gather of its ``h_dst`` follows ``take_along_axis``
    (-1 counts from the block's end, NaN outside), whose NaN stays in that
    edge's own state: forward and loss equal the reference's."""
    jcfg, cfg, _, params, _, model = _smoke_case("graphcast")
    batch = blocked_batch(np.random.default_rng(9), cfg)
    batch["dst_local"][1, 5] = bad  # block 1, a valid edge
    jb = _jax_batch(batch)
    want_out, want_loss = jax.jit(lambda p: (jgraphcast.forward_blocked(jcfg, p, jb),
                                             jgraphcast.loss_fn_blocked(jcfg, p, jb)))(params)
    want_out, want_loss = np.asarray(want_out), float(want_loss)
    tb = to_torch(batch)
    with torch.no_grad():
        out = graphcast.forward_blocked(cfg, model, tb)
        loss = float(graphcast.loss_fn_blocked(cfg, model, tb))
        assert np.isfinite(want_out).all()
        _assert_out_close(out, want_out)
        np.testing.assert_allclose(loss, want_loss, rtol=RTOL, atol=ATOL)
        # the edge masked instead gives the same result: it was dropped
        masked = dict(batch, edge_mask=batch["edge_mask"].copy())
        masked["edge_mask"][1, 5] = False
        masked["dst_local"] = batch["dst_local"].copy()
        masked["dst_local"][1, 5] = 0
        np.testing.assert_allclose(float(graphcast.loss_fn_blocked(cfg, model, to_torch(masked))), loss,
                                   rtol=RTOL, atol=ATOL)
        if 0 <= bad < 2 * 12:  # the flat list would land it in block 2's rows instead
            spilled = float(graphcast.loss_fn(cfg, model, to_torch(flat_edges(batch))))
            assert abs(spilled - loss) > 1e-4


# ---------------- configs, shapes, registry, trees ----------------

def test_gnn_shapes_and_pad_to_match_jax():
    assert steps.GNN_SHAPES == jsteps.GNN_SHAPES
    for n in (0, 1, 511, 512, 513, 10556, 168_960, 61_859_140):
        for m in (128, 512):
            assert steps.pad_to(n, m) == jsteps.pad_to(n, m)


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    assert out.pop("dtype") in (torch.float32, jnp.float32)
    return out


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_configs_match_jax_field_for_field(arch):
    jmod, mod = jax_get_arch(arch), get_arch(arch)
    assert (mod.ARCH_ID, mod.FAMILY, mod.SHAPES) == (jmod.ARCH_ID, jmod.FAMILY, jmod.SHAPES)
    pairs = [(mod.make_smoke_config(), jmod.make_smoke_config())]
    pairs += [(mod.make_config(s), jmod.make_config(s)) for s in mod.SHAPES]
    pairs.append((mod.make_config(), jmod.make_config()))
    for got, want in pairs:
        assert _fields(got) == _fields(want)
        assert got.dtype == torch.float32


def test_registry_names_the_gnn_archs():
    for arch in GNN_ARCHS:
        assert arch in ASSIGNED_ARCHS
        assert get_arch(arch).FAMILY == "gnn"
    assert get_arch("paper-graph-engine").FAMILY == "graph"


def test_tree_functions_take_lists_in_jax_order():
    tree = {"b": [np.zeros(1), {"y": np.ones(2), "x": np.ones(3)}], "a": np.ones(4),
            "c": [np.ones(5)] * 11}
    t = tree_map(torch.from_numpy, tree)
    assert [p for p, _ in tree_paths(t)] == ["a", "b/0", "b/1/x", "b/1/y"] + [f"c/{i}" for i in range(11)]
    assert [x.numel() for x in tree_leaves(t)] == [x.size for x in jax.tree.leaves(tree)]
    doubled = tree_map(lambda x, y: x + y, t, t)
    assert isinstance(doubled["b"], list) and float(doubled["b"][1]["x"][0]) == 2.0
