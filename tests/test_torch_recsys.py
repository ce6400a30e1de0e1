"""The port's retrieval slice against the JAX package on the CPU, on the
same inputs and weights: the embedding layers, the MLP, the weight
converter, both towers, candidate scoring, the example's serving flow,
the group-width planner, the config and the registry."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import XEON_E5_2660V4 as JAX_XEON  # noqa: E402
from repro.kernels.scoring import score_topk as jax_score_topk  # noqa: E402
from repro.launch.steps import RECSYS_SHAPES as JAX_RECSYS_SHAPES  # noqa: E402
from repro.layers import embedding as jax_embedding  # noqa: E402
from repro.models import recsys as jtt  # noqa: E402
from repro.models.gnn.common import mlp_apply as jax_mlp_apply  # noqa: E402
from repro.models.gnn.common import mlp_init as jax_mlp_init  # noqa: E402
from repro.serving import plan_group_width as jax_plan_group_width  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_arch  # noqa: E402
from repro_torch.kernels.embedding_bag import embedding_bag_cuda  # noqa: E402
from repro_torch.kernels.scoring import score_topk  # noqa: E402
from repro_torch.launch.steps import RECSYS_SHAPES  # noqa: E402
from repro_torch.layers import embedding  # noqa: E402
from repro_torch.models import recsys as tt  # noqa: E402
from repro_torch.models.gnn.common import MLP, mlp_state_from_jax  # noqa: E402
from repro_torch.serving import plan_group_width  # noqa: E402

# f32 sums of the same terms, only reordered (the towers' products, the
# bags' sums) stay within 1e-5 relative; scores as the JAX scoring tests
EMB_RTOL, EMB_ATOL = 1e-5, 1e-6
SCORE_TOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cfg(jcfg) -> tt.TwoTowerConfig:
    """The port's config with the numbers of a JAX-package config."""
    fields = lambda fs: tuple(tt.FieldSpec(f.name, f.vocab, f.multi_hot) for f in fs)  # noqa: E731
    return tt.TwoTowerConfig(
        name=jcfg.name, embed_dim=jcfg.embed_dim, tower_mlp=tuple(jcfg.tower_mlp),
        user_fields=fields(jcfg.user_fields), item_fields=fields(jcfg.item_fields),
        temperature=jcfg.temperature,
    )


# a narrow config whose multi-hot fields carry weights (``<field>_w``)
WEIGHTED_JCFG = jtt.TwoTowerConfig(
    embed_dim=24, tower_mlp=(40, 24),
    user_fields=(jtt.FieldSpec("user_id", 700), jtt.FieldSpec("user_history", 300, multi_hot=6),
                 jtt.FieldSpec("user_geo", 50)),
    item_fields=(jtt.FieldSpec("item_id", 900), jtt.FieldSpec("item_tags", 200, multi_hot=5)),
)


def _pair(jcfg, seed=0):
    """The JAX model's parameters and the port's model holding the same."""
    params = jtt.init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = _port_cfg(jcfg)
    model = tt.TwoTower(cfg, seed=seed + 1, device="cpu")
    model.load_state_dict(tt.params_from_jax(cfg, _np_tree(params)))
    return params, cfg, model


def _feats(fields, b, rng, weighted=True):
    out = {f.name: rng.integers(0, f.vocab, (b, f.multi_hot)).astype(np.int32) for f in fields}
    if weighted:
        for f in fields:
            if f.multi_hot > 1:
                w = rng.random((b, f.multi_hot)).astype(np.float32)
                w[:, -1] = 0.0  # the fixed hot-size's padding
                out[f.name + "_w"] = w
    return out


def _j(feats):
    return {k: jnp.asarray(v) for k, v in feats.items()}


def _t(feats):
    return {k: torch.from_numpy(v) for k, v in feats.items()}


# ---------------- layers ----------------

@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_layer_matches_jax(mode, weighted):
    rng = np.random.default_rng(5)
    table = rng.normal(size=(120, 16)).astype(np.float32)
    ids = rng.integers(0, 120, 90).astype(np.int32)
    segs = rng.integers(0, 12, 90).astype(np.int32)
    segs[segs == 4] = 5  # bag 4 is empty
    w = rng.normal(size=90).astype(np.float32) if weighted else None
    want = np.asarray(jax_embedding.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(segs), 12, mode=mode,
        weights=None if w is None else jnp.asarray(w)))
    got = embedding.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(segs), 12, mode=mode,
        weights=None if w is None else torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)  # -inf rows compare equal


def test_embed_matches_jax():
    rng = np.random.default_rng(6)
    table = rng.normal(size=(30, 4)).astype(np.float32)
    ids = rng.integers(0, 30, (5, 3)).astype(np.int32)
    want = np.asarray(jax_embedding.embed(jnp.asarray(table), jnp.asarray(ids)))
    np.testing.assert_array_equal(embedding.embed(torch.from_numpy(table), torch.from_numpy(ids)).numpy(), want)


def test_embedding_bag_layer_rejects_unknown_mode():
    with pytest.raises(ValueError):
        embedding.embedding_bag(torch.zeros(3, 2), torch.zeros(1, dtype=torch.int32),
                                torch.zeros(1, dtype=torch.int32), 1, mode="median")


@pytest.mark.parametrize("layernorm", [False, True])
def test_mlp_matches_jax(layernorm):
    sizes = [12, 20, 20, 7]  # a square middle layer: a wrong transpose keeps its shape
    jp = jax_mlp_init(jax.random.PRNGKey(3), sizes, layernorm=layernorm)
    if layernorm:  # non-trivial scale and bias
        jp["ln_scale"] = jp["ln_scale"] * 1.5
        jp["ln_bias"] = jp["ln_bias"] + 0.25
    mlp = MLP(sizes, layernorm=layernorm, device="cpu")
    mlp.load_state_dict(mlp_state_from_jax(_np_tree(jp)))
    x = np.random.default_rng(4).normal(size=(9, 12)).astype(np.float32)
    want = np.asarray(jax_mlp_apply(jp, jnp.asarray(x)))
    with torch.no_grad():
        got = mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=EMB_RTOL, atol=EMB_ATOL)


def test_mlp_init_follows_the_reference_scale():
    gen = torch.Generator().manual_seed(0)
    mlp = MLP([256, 512, 8], layernorm=False, device="cpu", generator=gen)
    w = mlp.layers[0].weight
    assert w.shape == (512, 256)  # nn.Linear's [out, in]
    assert abs(float(w.detach().std()) - 256 ** -0.5) < 0.003
    assert not mlp.layers[0].bias.any() and mlp.norm is None


# ---------------- the model ----------------

def test_params_from_jax_carries_every_tensor_with_its_layout():
    jcfg = WEIGHTED_JCFG
    params = _np_tree(jtt.init_params(jcfg, jax.random.PRNGKey(1)))
    cfg = _port_cfg(jcfg)
    state = tt.params_from_jax(cfg, params)
    model = tt.TwoTower(cfg, device="cpu")
    assert set(state) == set(model.state_dict())
    n_jax = len(jax.tree_util.tree_leaves(params))
    assert len(state) == n_jax  # every leaf of init_params, and nothing else
    for side, fields in (("user", cfg.user_fields), ("item", cfg.item_fields)):
        for f in fields:
            np.testing.assert_array_equal(state[f"{side}_tables.{f.name}"].numpy(),
                                          params[f"{side}_tables"][f.name])
        for i, layer in enumerate(params[f"{side}_tower"]["layers"]):
            np.testing.assert_array_equal(state[f"{side}_tower.layers.{i}.weight"].numpy(), layer["w"].T)
            np.testing.assert_array_equal(state[f"{side}_tower.layers.{i}.bias"].numpy(), layer["b"])
    model.load_state_dict(state)
    assert torch.equal(model.item_tower.layers[1].weight, state["item_tower.layers.1.weight"])


@pytest.mark.parametrize("which", ["smoke", "weighted"])
def test_towers_match_jax(which):
    jcfg = jax_get_arch("two-tower-retrieval").make_smoke_config() if which == "smoke" else WEIGHTED_JCFG
    params, cfg, model = _pair(jcfg)
    rng = np.random.default_rng(7)
    for fields, j_fn, t_fn, b in (
        (cfg.user_fields, jtt.user_embedding, model.user_embedding, 13),
        (cfg.item_fields, jtt.item_embedding, model.item_embedding, 300),
    ):
        feats = _feats(fields, b, rng, weighted=which == "weighted")
        want = np.asarray(j_fn(jcfg, params, _j(feats), b))
        got = t_fn(_t(feats), b)
        assert got.shape == (b, cfg.tower_mlp[-1]) and not got.requires_grad
        np.testing.assert_allclose(got.numpy(), want, rtol=EMB_RTOL, atol=EMB_ATOL)


def test_score_candidates_matches_jax():
    params, cfg, model = _pair(WEIGHTED_JCFG, seed=2)
    rng = np.random.default_rng(8)
    items = _feats(cfg.item_fields, 3000, rng)
    corpus_j = jtt.item_embedding(WEIGHTED_JCFG, params, _j(items), 3000)
    corpus_t = model.item_embedding(_t(items), 3000)
    users = _feats(cfg.user_fields, 6, rng)
    jv, ji = jtt.score_candidates(WEIGHTED_JCFG, params, _j(users), corpus_j, top_k=20)
    v, i = model.score_candidates(_t(users), corpus_t, top_k=20)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=SCORE_TOL, atol=SCORE_TOL)


def test_serve_retrieval_flow_matches_jax():
    """examples/serve_retrieval.py at its smoke size: a 4096-item corpus
    through the item tower, then user batches scored with k=10; the top-k
    indices equal JAX's (the corpus repeats items, so equal scores are
    ordered by index as ``lax.top_k`` orders them)."""
    jcfg = jax_get_arch("two-tower-retrieval").make_smoke_config()
    params, cfg, model = _pair(jcfg)
    rng = np.random.default_rng(0)
    items = _feats(cfg.item_fields, 4096, rng)
    corpus_j = jtt.item_embedding(jcfg, params, _j(items), 4096)
    corpus_t = model.item_embedding(_t(items), 4096)
    np.testing.assert_allclose(corpus_t.numpy(), np.asarray(corpus_j), rtol=EMB_RTOL, atol=EMB_ATOL)
    for batch, queue_depth in ((4, 1), (64, 1), (4, 32)):
        users = _feats(cfg.user_fields, batch, rng)
        u_j = jtt.user_embedding(jcfg, params, _j(users), batch)
        u_t = model.user_embedding(_t(users), batch)
        jv, ji = jax_score_topk(u_j, corpus_j, k=10)
        v, i = score_topk(u_t, corpus_t, 10)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=SCORE_TOL, atol=SCORE_TOL)
        kw = dict(batch=batch, cache_len=4096, n_kv_heads=1, head_dim=corpus_t.shape[1],
                  n_layers=1, queue_depth=queue_depth)
        assert plan_group_width(core.XEON_E5_2660V4, **kw) == jax_plan_group_width(JAX_XEON, **kw)


def test_model_refuses_cpu_without_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("two-tower-retrieval").make_smoke_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.TwoTower(cfg)
    assert next(tt.TwoTower(cfg, device="cpu").parameters()).device.type == "cpu"


def test_model_init_is_seeded():
    cfg = get_arch("two-tower-retrieval").make_smoke_config()
    a, b, c = (tt.TwoTower(cfg, seed=s, device="cpu") for s in (4, 4, 5))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert not torch.equal(a.user_tables["user_id"], c.user_tables["user_id"])
    assert abs(float(a.user_tables["user_id"].detach().std()) - 0.01) < 0.001


def test_towers_on_cpu_never_launch_the_kernel():
    _, cfg, model = _pair(WEIGHTED_JCFG)
    before = embedding_bag_cuda.launches
    model.user_embedding(_t(_feats(cfg.user_fields, 3, np.random.default_rng(1))), 3)
    assert embedding_bag_cuda.launches == before


# ---------------- serving, configs, registry ----------------

@pytest.mark.parametrize("batch,queue_depth", [(4, 1), (64, 1), (4, 32), (1, 1), (512, 1),
                                               (512, 8), (64, 56), (1, 64)])
@pytest.mark.parametrize("cache_len", [4096, 1_048_576])
def test_plan_group_width_equals_jax(batch, queue_depth, cache_len):
    kw = dict(batch=batch, cache_len=cache_len, n_kv_heads=1, head_dim=256, n_layers=1,
              queue_depth=queue_depth)
    got = plan_group_width(core.XEON_E5_2660V4, **kw)
    assert isinstance(got, int) and got == jax_plan_group_width(JAX_XEON, **kw)


def test_plan_group_width_needs_a_hardware_model():
    with pytest.raises(TypeError):
        plan_group_width(batch=4, cache_len=4096, n_kv_heads=1, head_dim=16, n_layers=1,  # noqa
                         queue_depth=1)


def test_configs_and_shapes_equal_the_reference():
    assert RECSYS_SHAPES == JAX_RECSYS_SHAPES
    mod, jmod = get_arch("two-tower-retrieval"), jax_get_arch("two-tower-retrieval")
    assert (mod.ARCH_ID, mod.FAMILY, mod.SHAPES) == (jmod.ARCH_ID, jmod.FAMILY, jmod.SHAPES)
    for make in ("make_config", "make_smoke_config"):
        got, want = getattr(mod, make)(), getattr(jmod, make)()
        assert dataclasses.asdict(got) | {"dtype": None} == dataclasses.asdict(want) | {"dtype": None}
        assert got.dtype == torch.float32
    full = mod.make_config()
    n = sum(f.vocab for f in (*full.user_fields, *full.item_fields))
    assert n == 18_104_320 and n * full.embed_dim * 4 == 18_538_823_680  # 18.54 GB of f32 tables


def test_registry_resolves_ported_and_refuses_the_rest():
    # every arch is ported since the dry-run slice: the registry refuses
    # only names it does not know, as the reference's does
    assert "two-tower-retrieval" in ASSIGNED_ARCHS
    assert get_arch("two-tower-retrieval").ARCH_ID == "two-tower-retrieval"
    assert get_arch("paper-graph-engine").ARCH_ID == "paper-graph-engine"
    with pytest.raises(KeyError, match="unknown arch.*two-tower-retrieval"):
        get_arch("no-such-arch")
