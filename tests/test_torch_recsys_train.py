"""Two-tower training in the port against the JAX package on the CPU: the
id rule of the EmbeddingBag (``jnp.take``'s: wrap a negative id, NaN past
the ends, no gradient there) in every mode, ``EmbeddingBagFunction``'s
gradients against ``jax.grad``, ``loss_fn`` and its gradients,
``recsys_train_step`` and ``recsys_serve_step`` against the reference's
own cell programs (``make_recsys_cell``'s ``step_fn`` on concrete arrays),
the in-place clip and AdamW against the functional ones, and the parameter
tree's layout."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.tree_util import tree_flatten_with_path  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch.steps import make_recsys_cell  # noqa: E402
from repro.layers import embedding as jax_layers  # noqa: E402
from repro.models import recsys as jtt  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map, tree_paths  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    EmbeddingBagFunction,
    embedding_bag,
    embedding_bag_cuda,
    embedding_bag_plain,
    embedding_bag_ref,
    take_rows,
)
from repro_torch.launch.steps import recsys_serve_step, recsys_train_step  # noqa: E402
from repro_torch.layers import embedding as torch_layers  # noqa: E402
from repro_torch.models import recsys as tt  # noqa: E402

from _torch_bench_rows import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread a test)
from _torch_recsys import STEP_EPS, make_batch, to_torch  # noqa: E402

# the bags' float32 sums, and the backward's sums of repeated ids' terms,
# in another order than XLA's
BAG_RTOL, BAG_ATOL = 1e-5, 1e-6
# a loss and a gradient norm: float32 sums in another order
STEP_RTOL = 1e-5
# gradients of the loss: float32 noise of the towers' products and the
# in-batch softmax, held to each leaf's scale
GRAD_REL = 1e-5
# weights after steps of lr 1e-3 from such gradients (tests/test_torch_gnn_train.py)
PARAM_ATOL = 1e-6
# the moments, within the gradients' float32 noise (each leaf's scale)
MOMENT_REL = 1e-4


def _paths(tree) -> list[str]:
    return [jax.tree_util.keystr(p) for p, _ in tree_flatten_with_path(tree)[0]]


def _port_cfg(jcfg) -> tt.TwoTowerConfig:
    """The port's config with the numbers of a JAX-package config."""
    fields = lambda fs: tuple(tt.FieldSpec(f.name, f.vocab, f.multi_hot) for f in fs)  # noqa: E731
    return tt.TwoTowerConfig(
        name=jcfg.name, embed_dim=jcfg.embed_dim, tower_mlp=tuple(jcfg.tower_mlp),
        user_fields=fields(jcfg.user_fields), item_fields=fields(jcfg.item_fields),
        temperature=jcfg.temperature,
    )


# a narrow config whose multi-hot fields carry weights (``<field>_w``), as
# tests/test_torch_recsys.py's
WEIGHTED_JCFG = jtt.TwoTowerConfig(
    embed_dim=24, tower_mlp=(40, 24),
    user_fields=(jtt.FieldSpec("user_id", 700), jtt.FieldSpec("user_history", 300, multi_hot=6),
                 jtt.FieldSpec("user_geo", 50)),
    item_fields=(jtt.FieldSpec("item_id", 900), jtt.FieldSpec("item_tags", 200, multi_hot=5)),
)
CONFIGS = ["smoke", "weighted"]


def _jcfg(which: str):
    return jax_get_arch("two-tower-retrieval").make_smoke_config() if which == "smoke" else WEIGHTED_JCFG


def _pair(jcfg, seed=0):
    """The reference's parameters (numpy) and the port's model holding them."""
    params = jax.tree.map(np.asarray, jtt.init_params(jcfg, jax.random.PRNGKey(seed)))
    cfg = _port_cfg(jcfg)
    model = tt.TwoTower(cfg, seed=seed + 1, device="cpu")
    model.load_state_dict(tt.params_from_jax(cfg, params))
    return params, cfg, model


def _jbatch(batch):
    return jax.tree.map(jnp.asarray, batch)


def _assert_leaves_close(got_tree, want_tree, rel, what=""):
    """Each leaf within ``rel`` of the reference leaf's largest entry."""
    for path, g, w in zip(_paths(want_tree), tree_leaves(got_tree), jax.tree.leaves(want_tree)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=rel * float(np.abs(w).max()) + 1e-12,
                                   err_msg=f"{what} {path}")


# ---------------- the id rule ----------------

V, D, BAGS = 9, 4, 6
# every kind of id: inside, each end's wrap (-1, -V), the first ids past
# either end (V, -V - 1) and one far past (V + 5); bag 3 reads only wrapped
# ids, bag 4 only valid ones, bag 5 none; the last two ids lie outside the
# bags (segments -1 and BAGS), one of them NaN-filled
RULE_IDS = np.array([0, -1, 3, V, 2, -V, V + 5, 8, -V - 1, -2, -V, 1, 4, 4, V, 5], np.int32)
RULE_SEGS = np.array([0, 0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 4, 4, 4, -1, BAGS], np.int32)


def test_take_rule_equals_jnp_take():
    """``take_rows`` is ``jnp.take(table, ids, axis=0)`` bit for bit, at
    -V - 1 too (jnp.take fills NaN there: it wraps [-V, 0) only)."""
    table = np.random.default_rng(0).normal(size=(V, D)).astype(np.float32)
    ids = np.array([-V - 1, -V, -1, 0, V - 1, V, V + 5, -3 * V], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    assert np.isnan(want[[0, 5, 6, 7]]).all() and not np.isnan(want[1:5]).any()
    np.testing.assert_array_equal(take_rows(torch.from_numpy(table), torch.from_numpy(ids)).numpy(), want)
    np.testing.assert_array_equal(torch_layers.embed(torch.from_numpy(table), torch.from_numpy(ids)).numpy(),
                                  np.asarray(jax_layers.embed(jnp.asarray(table), jnp.asarray(ids))))


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_id_rule_matches_jax(mode, weighted):
    """Forward and ``jax.grad`` of the reference's ``embedding_bag`` at ids
    -1, -V, V, V + 5 and -V - 1: NaN in the same places, the wrapped ids'
    gradients on their rows, none from the NaN-filled ids (the weights'
    gradient NaN there, as the reference's product rule gives)."""
    rng = np.random.default_rng(len(mode) + weighted)
    table = rng.normal(size=(V, D)).astype(np.float32)
    w = rng.normal(size=RULE_IDS.shape[0]).astype(np.float32) if weighted else None
    cot = rng.normal(size=(BAGS, D)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda t, w_: jax_layers.embedding_bag(t, jnp.asarray(RULE_IDS), jnp.asarray(RULE_SEGS), BAGS,
                                               mode=mode, weights=w_),
        jnp.asarray(table), None if w is None else jnp.asarray(w))
    want_t, want_w = vjp(jnp.asarray(cot))
    t = torch.from_numpy(table).requires_grad_()
    tw = None if w is None else torch.from_numpy(w).requires_grad_()
    got = torch_layers.embedding_bag(t, torch.from_numpy(RULE_IDS), torch.from_numpy(RULE_SEGS), BAGS,
                                     mode=mode, weights=tw)
    got.backward(torch.from_numpy(cot))
    nan_bags = np.isnan(np.asarray(want)).all(-1)
    assert nan_bags.tolist() == [True, True, True, False, False, False]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=BAG_RTOL, atol=BAG_ATOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_t), rtol=BAG_RTOL, atol=BAG_ATOL)
    if weighted:
        assert np.isnan(np.asarray(want_w)).tolist() == np.isnan(tw.grad.numpy()).tolist()
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_w), rtol=BAG_RTOL, atol=BAG_ATOL)
    if mode == "sum":  # the plain version and the oracle on sorted ids follow the rule too
        order = np.argsort(RULE_SEGS, kind="stable")
        args = [torch.from_numpy(a) for a in (table, RULE_IDS[order], RULE_SEGS[order])]
        ww = None if w is None else torch.from_numpy(w[order])
        plain = embedding_bag_plain(*args, ww, BAGS)
        ref = embedding_bag_ref(*args, torch.ones(len(order)) if ww is None else ww, BAGS)
        for out in (plain, ref):
            np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=BAG_RTOL, atol=BAG_ATOL)


# ---------------- EmbeddingBagFunction ----------------

FUNCTION_CASES = {
    # name: (table rows, D, ids, segments, bags): ids and segments drawn
    # from the seed where None
    "repeated_ids": (40, 8, [3, 3, 3, 7, 3, 7, 3, 3], [0, 0, 1, 1, 2, 2, 2, 4], 5),
    "out_of_range_segments": (300, 16, None, (-4, 40), 30),
    "unsorted_with_empty_bags": (200, 16, None, (0, 40), 50),
    "hot_row": (500, 32, "zipf", (0, 64), 64),
}


def _function_case(case: str, weighted: bool):
    v, d, ids, segs, b = FUNCTION_CASES[case]
    rng = np.random.default_rng(len(case) + 10 * weighted)
    table = rng.normal(size=(v, d)).astype(np.float32)
    n = 400 if not isinstance(ids, list) else len(ids)
    if ids is None:
        ids = rng.integers(0, v, n)
    elif ids == "zipf":  # many repeats of a few rows, as the training stream's history
        ids = rng.zipf(1.2, n) % v
    segs = rng.integers(*segs, n) if isinstance(segs, tuple) else segs
    w = rng.normal(size=n).astype(np.float32) if weighted else None
    return table, np.asarray(ids, np.int32), np.asarray(segs, np.int32), w, b, rng


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("case", list(FUNCTION_CASES))
def test_embedding_bag_function_grads_match_jax(case, weighted):
    """The Function's table and weight gradients against ``jax.vjp`` of the
    reference's ``embedding_bag`` (sum): dense table gradients, repeated
    ids summed, out-of-range segments dropped; on the CPU it runs the plain
    forward and never the kernel."""
    table, ids, segs, w, b, rng = _function_case(case, weighted)
    cot = rng.normal(size=(b, table.shape[1])).astype(np.float32)
    want, vjp = jax.vjp(
        lambda t, w_: jax_layers.embedding_bag(t, jnp.asarray(ids), jnp.asarray(segs), b, weights=w_),
        jnp.asarray(table), None if w is None else jnp.asarray(w))
    want_t, want_w = vjp(jnp.asarray(cot))
    t = torch.from_numpy(table).requires_grad_()
    tw = None if w is None else torch.from_numpy(w).requires_grad_()
    before = embedding_bag_cuda.launches
    got = embedding_bag(t, torch.from_numpy(ids), torch.from_numpy(segs), b, weights=tw)
    assert type(got.grad_fn).__name__ == "EmbeddingBagFunctionBackward"
    got.backward(torch.from_numpy(cot))
    assert embedding_bag_cuda.launches == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=BAG_RTOL, atol=BAG_ATOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_t), rtol=BAG_RTOL, atol=BAG_ATOL)
    if weighted:
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_w), rtol=BAG_RTOL, atol=BAG_ATOL)
    with torch.no_grad():  # no gradient wanted: the forward alone, no Function
        assert embedding_bag(t, torch.from_numpy(ids), torch.from_numpy(segs), b, weights=tw).grad_fn is None


def test_embedding_bag_function_grads_equal_plain_autograd():
    """The Function's backward against autograd through the plain version
    on the same sorted inputs, the id rule's ids included: the same bits,
    NaN in the same places."""
    rng = np.random.default_rng(2)
    table = rng.normal(size=(V, D)).astype(np.float32)
    order = np.argsort(RULE_SEGS, kind="stable")
    ids, segs = torch.from_numpy(RULE_IDS[order]), torch.from_numpy(RULE_SEGS[order])
    w = rng.normal(size=len(order)).astype(np.float32)
    cot = torch.from_numpy(rng.normal(size=(BAGS, D)).astype(np.float32))
    grads = []
    for fn in (lambda *a: EmbeddingBagFunction.apply(*a, BAGS), lambda *a: embedding_bag_plain(*a, BAGS)):
        t, tw = torch.from_numpy(table).requires_grad_(), torch.from_numpy(w).requires_grad_()
        fn(t, ids, segs, tw).backward(cot)
        grads.append((t.grad, tw.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


# ---------------- the model ----------------

def test_init_params_and_params_tree_are_laid_out_as_the_reference():
    """``init_params``/``params_tree`` give the reference's tree (the same
    paths and shapes as ``init_params(cfg, key)``, at its scales); the
    leaves are views that write through to the model; ``grads=True`` gives
    the ``.grad`` tensors themselves."""
    jcfg = WEIGHTED_JCFG
    cfg = _port_cfg(jcfg)
    want = jtt.init_params(jcfg, jax.random.PRNGKey(0))
    got = tt.init_params(cfg, seed=3, device="cpu")
    want_paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
                  for path, _ in tree_flatten_with_path(want)[0]]
    assert [p for p, _ in tree_paths(got)] == want_paths
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    assert abs(float(got["user_tables"]["user_id"].std()) - 0.01) < 0.001
    w0 = got["item_tower"]["layers"][0]["w"]
    assert abs(float(w0.std()) - w0.shape[0] ** -0.5) < 0.01 and not got["item_tower"]["layers"][0]["b"].any()

    model = tt.TwoTower(cfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tt.params_tree(model)), tree_leaves(got)))
    tree = tt.params_tree(model)
    tree["user_tables"]["user_geo"][2, 1] = 5.0
    tree["user_tower"]["layers"][1]["w"][3, 0] = 7.0  # [in, out]: the Linear's weight[0, 3]
    assert float(model.user_tables["user_geo"].detach()[2, 1]) == 5.0
    assert float(model.user_tower.layers[1].weight.detach()[0, 3]) == 7.0
    rng = np.random.default_rng(1)
    tt.loss_fn(cfg, model, to_torch(make_batch(cfg, 8, rng, weighted=True))).backward()
    grads = tt.params_tree(model, grads=True)
    assert grads["item_tables"]["item_tags"] is model.item_tables["item_tags"].grad
    assert grads["user_tower"]["layers"][0]["w"].data_ptr() == model.user_tower.layers[0].weight.grad.data_ptr()


def test_towers_carry_gradients_and_serving_does_not():
    _, cfg, model = _pair(WEIGHTED_JCFG)
    feats = to_torch(make_batch(cfg, 5, np.random.default_rng(3), weighted=True)["user"])
    assert tt.user_embedding(cfg, model, feats, 5).requires_grad
    assert not model.user_embedding(feats, 5).requires_grad


@pytest.mark.parametrize("which", CONFIGS)
def test_loss_and_gradients_match_jax(which):
    """``loss_fn`` and every gradient leaf against ``jax.value_and_grad`` of
    the reference's ``loss_fn`` on the same weights and batch (the
    counterpart of tests/test_arch_smoke.py::test_recsys_smoke_train_and_score)."""
    jcfg = _jcfg(which)
    params, cfg, model = _pair(jcfg)
    batch = make_batch(cfg, 24, np.random.default_rng(4), weighted=which == "weighted")
    want, want_g = jax.value_and_grad(lambda p: jtt.loss_fn(jcfg, p, _jbatch(batch)))(params)
    loss = tt.loss_fn(cfg, model, to_torch(batch))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=STEP_RTOL)
    _assert_leaves_close(tt.params_tree(model, grads=True), want_g, GRAD_REL, "grad")


def _jopt_and_opt():
    kw = dict(name="adamw", lr=1e-3, warmup_steps=1, decay_steps=10, eps=STEP_EPS)
    return joptim.OptimizerConfig(**kw), optim.OptimizerConfig(**kw)


@pytest.mark.parametrize("which", CONFIGS)
def test_recsys_train_step_matches_the_reference_cell(which):
    """``recsys_train_step`` against ``make_recsys_cell(cfg, "train_batch",
    opt).step_fn`` for 2 steps: loss, gradient norm, weights and moments
    (AdamW's eps raised to 1e-4, as tests/test_torch_gnn_train.py does)."""
    jcfg = _jcfg(which)
    jopt, opt = _jopt_and_opt()
    cell = make_recsys_cell(jcfg, "train_batch", jopt)
    params, cfg, model = _pair(jcfg, seed=2)
    jstate = joptim.make_optimizer(jopt)[0](params)
    state = optim.adamw_init(tt.params_tree(model))
    step = recsys_train_step(cfg, opt)
    jstep = jax.jit(cell.step_fn)
    rng = np.random.default_rng(5)
    jp = params
    for _ in range(2):
        batch = make_batch(cfg, 32, rng, weighted=which == "weighted")
        jp, jstate, want = jstep(jp, jstate, _jbatch(batch))
        model, state, got = step(model, state, to_torch(batch))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=STEP_RTOL)
        np.testing.assert_allclose(float(got["gnorm"]), float(want["gnorm"]), rtol=STEP_RTOL)
        for path, g, w in zip(_paths(jp), tree_leaves(tt.params_tree(model)), jax.tree.leaves(jp)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=PARAM_ATOL, err_msg=path)
    assert int(state["step"]) == int(jstate["step"]) == 2
    assert all(p.grad is None for p in model.parameters())  # no gradient outlives the step
    for part in ("mu", "nu"):
        _assert_leaves_close(state[part], jstate[part], MOMENT_REL, part)


@pytest.mark.parametrize("which", CONFIGS)
def test_recsys_serve_step_matches_the_reference_cell(which):
    jcfg = _jcfg(which)
    cell = make_recsys_cell(jcfg, "serve_p99", joptim.OptimizerConfig(name="adamw", lr=1e-3))
    b = cell.meta["batch"]
    params, cfg, model = _pair(jcfg, seed=4)
    batch = make_batch(cfg, b, np.random.default_rng(6), weighted=which == "weighted")
    want = np.asarray(jax.jit(cell.step_fn)(params, _jbatch(batch["user"]), _jbatch(batch["item"])))
    got = recsys_serve_step(cfg)(model, to_torch(batch["user"]), to_torch(batch["item"]))
    assert got.shape == (b,) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=BAG_RTOL, atol=BAG_ATOL)


# ---------------- AdamW and clipping in place ----------------

def _opt_tree(rng, rows: int):
    """A tree like the two-tower's: a table of ``rows`` rows, a transposed
    view (a tower weight as the reference lays it out) and a bias."""
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    return {"tables": {"a": t(rows, 8), "b": t(5, 8)},
            "tower": {"layers": [{"w": t(6, 12).T, "b": t(6)}]}}


@pytest.mark.parametrize("max_norm", [0.5, 1e9], ids=["clipping", "not_clipping"])
@pytest.mark.parametrize("chunk_rows", [optim.CHUNK_ROWS, 7], ids=["default_chunks", "leaf_split"])
def test_inplace_adamw_and_clip_are_bit_equal_to_the_functional(chunk_rows, max_norm):
    """Three steps of ``clip_by_global_norm_`` + ``adamw_update_`` against
    the functional forms: the scaled gradients ``g * scale`` in bits (the
    functional ones too where the norm's sums ran in the same order), the
    norm within float32 rounding of its sum's order, and from the same
    gradients the parameters, moments and step equal in bits (the 50-row
    table splits into 8 chunks of 7 rows)."""
    rng = np.random.default_rng(7)
    cfg = optim.OptimizerConfig(name="adamw", lr=1e-2, warmup_steps=2, decay_steps=10)
    params = _opt_tree(rng, 50)
    ref_params = tree_map(lambda p: p.clone(), params)
    state, ref_state = optim.adamw_init(params), optim.adamw_init(ref_params)
    init, update = optim.make_optimizer(cfg, in_place=True)
    assert init is optim.adamw_init and update is optim.adamw_update_
    for _ in range(3):
        grads = tree_map(lambda p: torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32)), params)
        raw = tree_map(lambda g: g.clone(), grads)
        ref_grads, ref_norm = optim.clip_by_global_norm(raw, max_norm)
        norm = optim.clip_by_global_norm_(grads, max_norm, chunk_rows=chunk_rows)
        np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
        scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
        for g, r in zip(tree_leaves(grads), tree_leaves(raw)):
            assert torch.equal(g, r * scale)
        if chunk_rows == optim.CHUNK_ROWS:  # every leaf one chunk: the functional sums in their order
            assert torch.equal(norm, ref_norm)
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(ref_grads)))
        ref_params, ref_state = optim.adamw_update(cfg, tree_map(lambda g: g.clone(), grads), ref_state,
                                                   ref_params)
        state = update(cfg, grads, state, params, chunk_rows=chunk_rows)
        for tree, ref in ((params, ref_params), (state["mu"], ref_state["mu"]), (state["nu"], ref_state["nu"])):
            for a, b in zip(tree_leaves(tree), tree_leaves(ref)):
                assert torch.equal(a, b)
    assert int(state["step"]) == int(ref_state["step"]) == 3
    assert params["tower"]["layers"][0]["w"].stride() == (1, 12)  # updated through the transposed view


def test_inplace_update_is_adamw_only():
    with pytest.raises(ValueError, match="AdamW only"):
        optim.make_optimizer(optim.OptimizerConfig(name="adafactor"), in_place=True)
