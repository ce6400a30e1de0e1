"""The dry-run slice's sharding rules, mesh plans and tree helpers against
the JAX package's: ``default_rules`` and ``spec_for`` on both production
layouts (the reference's on ``AbstractMesh``, no devices), including the
prefix fallback, the used-axis exclusion and replication; the logical-axis
trees, abstract parameters and caches of the LM configs at full width;
the optimizer-state axes of both optimizers; the GNN helpers; and the arch
registry. Every comparison is exact."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch._tree import tree_leaves  # noqa: E402
from _torch_cells import (  # noqa: E402
    GNN_SHAPES,
    LM_ARCHS,
    abstract_meshes,
    jax_axes,
    jax_shapes,
    port_axes,
    port_shapes,
)


def test_default_rules_equal_the_reference():
    from repro.sharding.rules import default_rules as jax_rules

    from repro_torch.sharding import default_rules

    for jmesh, mesh in abstract_meshes():
        assert default_rules(mesh) == jax_rules(jmesh)
        assert mesh.axis_names == jmesh.axis_names and dict(jmesh.shape) == mesh.shape
        assert mesh.size == jmesh.size


def test_spec_for_equals_the_reference_on_drawn_cases():
    """Random logical axes (rule names, unknown names, None) over dims made
    of the mesh sizes' divisors and odd factors, so every branch is taken:
    full flatten, a prefix that divides, an axis taken by an earlier dim,
    and replication."""
    from repro.sharding.rules import default_rules as jax_rules
    from repro.sharding.rules import spec_for as jax_spec_for

    from repro_torch.sharding import default_rules, spec_for

    rng = np.random.default_rng(0)
    names = list(jax_rules(abstract_meshes()[1][0])) + [None, "no_such_axis"]
    dims = [1, 2, 3, 7, 8, 16, 32, 48, 56, 96, 256, 512, 1024, 3 * 512, 7 * 16]
    seen = set()
    for jmesh, mesh in abstract_meshes():
        rules, jrules = default_rules(mesh), jax_rules(jmesh)
        for _ in range(2000):
            rank = int(rng.integers(0, 5))
            axes = tuple(names[i] for i in rng.integers(0, len(names), rank))
            shape = tuple(int(dims[i]) for i in rng.integers(0, len(dims), rank))
            got = spec_for(axes, shape, mesh, rules)
            assert got == tuple(jax_spec_for(axes, shape, jmesh, jrules)), (axes, shape)
            seen.update(type(p).__name__ for p in got)
        assert spec_for(None, (4, 4), mesh, rules) == ()
    assert seen == {"NoneType", "str", "tuple"}


def test_spec_for_takes_the_reference_branches_on_the_lm_heads():
    """granite's single KV head replicates, arctic's 56 heads replicate over
    'model' (and the next dim still takes 'data'), a dim that 32 divides but
    512 does not takes the ('pod', 'data') prefix of the flat axes."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import default_rules, spec_for

    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    rules = default_rules(single)
    assert spec_for(("layers", "embed", "kv_heads", "head_dim"), (88, 6144, 1, 128), single, rules) == (
        None, "data", None, None)
    assert spec_for(("heads", "embed"), (56, 7168), single, rules) == (None, "data")
    assert spec_for(("nodes",), (64,), multi, default_rules(multi)) == (("pod", "data"),)
    assert spec_for(("nodes",), (3,), multi, default_rules(multi)) == (None,)
    with pytest.raises(AssertionError, match="axes"):
        spec_for(("batch",), (4, 4), single, rules)


def test_sharding_and_replicated_trees():
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import replicated_tree, sharding_tree

    mesh = make_production_mesh()
    tree = {"a": torch.empty(32, 8, device="meta"), "b": [torch.empty(16, device="meta")],
            "c": torch.empty((), device="meta")}
    axes = {"a": ("batch", None), "b": [("mlp",)], "c": ()}
    assert sharding_tree(tree, axes, mesh) == {"a": ("data", None), "b": [("model",)], "c": ()}
    assert replicated_tree(tree, mesh) == {"a": (), "b": [()], "c": ()}


def test_meshes():
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (single.axis_names, single.shape, single.size, single.devices) == (
        ("data", "model"), {"data": 16, "model": 16}, 256, ())
    assert (multi.axis_names, list(multi.shape.values()), multi.size) == (("pod", "data", "model"), [2, 16, 16], 512)
    local = make_local_mesh(device="cpu")
    assert (local.shape, local.size, local.devices) == ({"data": 1, "model": 1}, 1, (torch.device("cpu"),))


def test_constrain_is_identity_and_checks_rank_under_a_context():
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import activation_sharding, active, constrain
    from repro_torch.sharding.context import scan_unroll, unrolled_scans

    x = torch.ones(4, 6)
    mesh = make_production_mesh()
    assert constrain(x, ("batch", "seq")) is x and active() is None
    with activation_sharding(mesh):
        assert active()[0] is mesh
        assert constrain(x, ("batch", "seq")) is x and constrain(x, None) is x
        with pytest.raises(AssertionError, match="axes"):
            constrain(x, ("batch",))
    assert active() is None
    assert not scan_unroll()
    with unrolled_scans():
        assert scan_unroll()
    assert not scan_unroll()


def test_sharding_package_exports_the_reference_names():
    import repro.sharding as jax_sharding

    import repro_torch.sharding as sharding

    assert sharding.__all__ == jax_sharding.__all__


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_axes_params_and_cache_equal_the_reference(arch):
    """Full width and depth: ``logical_axes``, ``abstract_params`` (meta,
    the reference's ``eval_shape``), ``abstract_cache`` at a decode shape,
    ``cache_logical_axes``, and ``opt_state_logical_axes`` of both
    optimizers over the param axes."""
    from repro.configs import get_arch as jax_arch
    from repro.models import transformer as jtf
    from repro.optim import OptimizerConfig as JOpt
    from repro.optim import opt_state_logical_axes as jax_opt_axes

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.optim import OptimizerConfig, opt_state_logical_axes

    cfg, jcfg = get_arch(arch).make_config(), jax_arch(arch).make_config()
    axes, jaxes = tf.logical_axes(cfg), jtf.logical_axes(jcfg)
    assert port_axes(axes) == jax_axes(jaxes)
    params = tf.abstract_params(cfg)
    assert {t.device.type for t in tree_leaves(params)} == {"meta"}
    assert port_shapes(params) == jax_shapes(jtf.abstract_params(jcfg))
    assert port_shapes(tf.abstract_cache(cfg, 8, 4096)) == jax_shapes(jtf.abstract_cache(jcfg, 8, 4096))
    assert port_axes(tf.cache_logical_axes()) == jax_axes(jtf.cache_logical_axes())
    for name in ("adamw", "adafactor"):
        got = opt_state_logical_axes(OptimizerConfig(name=name), axes)
        assert port_axes(got) == jax_axes(jax_opt_axes(JOpt(name=name), jaxes))


def test_init_params_is_the_models_tree():
    """``init_params`` draws the tree a ``TransformerLM`` of the same seed
    holds (the meta construction path leaves CPU draws as they were)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    cfg = get_arch("grok-1-314b").make_smoke_config()
    tree = tf.init_params(cfg, seed=5, device="cpu")
    model = tf.TransformerLM(cfg, seed=5, device="cpu", masters=True)
    want = tf.params_tree(model)
    got_leaves, want_leaves = port_shapes(tree), port_shapes(want)
    assert got_leaves == want_leaves
    for a, b in zip(tree_leaves(tree), tree_leaves(want)):
        assert torch.equal(a, b)
    assert port_shapes(tf.abstract_params(cfg)) == want_leaves


def test_masters_model_serves_as_the_serving_model():
    """The LM cells' serving steps take a float32 masters model and serve
    it through ``served_model``: the bits of the serving model (its
    matrices cast once) in bf16, and the masters model left as it was."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import served_model
    from repro_torch.models import transformer as tf

    for arch in ("tinyllama-1.1b", "arctic-480b"):
        cfg = dataclasses.replace(get_arch(arch).make_smoke_config(), dtype=torch.bfloat16)
        masters = tf.TransformerLM(cfg, seed=1, device="cpu", masters=True)
        before = {k: v.clone() for k, v in masters.state_dict().items()}
        served = served_model(cfg, masters)
        serving = tf.TransformerLM(cfg, seed=1, device="cpu")
        assert [(k, v.dtype, v.requires_grad) for k, v in served.named_parameters()] == \
            [(k, v.dtype, v.requires_grad) for k, v in serving.named_parameters()]
        tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 24)).astype(np.int32))
        with torch.no_grad():
            a_logits, a_cache = tf.prefill(cfg, served, tokens, max_len=32)
            b_logits, b_cache = tf.prefill(cfg, serving, tokens, max_len=32)
            assert a_logits.dtype == torch.bfloat16 and torch.equal(a_logits, b_logits)
            assert torch.equal(a_cache["k"], b_cache["k"]) and torch.equal(a_cache["v"], b_cache["v"])
            nxt = a_logits.argmax(-1)[:, None].to(torch.int32)
            a_step, _ = tf.decode_step(cfg, served, nxt, a_cache)
            b_step, _ = tf.decode_step(cfg, serving, nxt, b_cache)
            assert torch.equal(a_step, b_step)
        after = masters.state_dict()
        assert all(after[k].dtype == torch.float32 and torch.equal(after[k], v) for k, v in before.items())


def test_models_build_on_meta_with_the_cpu_shapes():
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys as tt
    from repro_torch.models.gnn import graphcast, meshgraphnet, pna, schnet

    cases = [(m.MODEL, get_arch(a).make_smoke_config()) for m, a in (
        (meshgraphnet, "meshgraphnet"), (pna, "pna"), (schnet, "schnet"), (graphcast, "graphcast"))]
    cases.append((tt.TwoTower, get_arch("two-tower-retrieval").make_smoke_config()))
    for cls, cfg in cases:
        meta, cpu = cls(cfg, device="meta").state_dict(), cls(cfg, device="cpu").state_dict()
        assert [(k, v.shape, v.dtype) for k, v in meta.items()] == [(k, v.shape, v.dtype) for k, v in cpu.items()]
        assert {v.device.type for v in meta.values()} == {"meta"}


def test_mlp_logical_axes_equal_the_reference():
    import jax
    from repro.models.gnn.common import mlp_init, mlp_logical_axes as jax_mlp_axes

    from repro_torch.models.gnn.common import MLP, mlp_logical_axes

    for sizes, ln in (([16, 32, 8], True), ([5, 7], False)):
        tree = MLP(sizes, layernorm=ln, device="meta").tree()
        jtree = mlp_init(jax.random.PRNGKey(0), sizes, layernorm=ln)
        for prefix in ((), ("layers",)):
            assert port_axes(mlp_logical_axes(tree, prefix)) == jax_axes(jax_mlp_axes(jtree, prefix))


@pytest.mark.parametrize("arch", ["meshgraphnet", "pna", "schnet", "graphcast", "two-tower-retrieval"])
def test_generic_param_axes_equal_the_reference(arch):
    import jax
    from repro.configs import get_arch as jax_arch
    from repro.launch.steps import generic_param_axes as jax_generic

    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import generic_param_axes

    cell, jcell = get_arch(arch).make_cell(get_arch(arch).SHAPES[0]), jax_arch(arch).make_cell(get_arch(arch).SHAPES[0])
    got = generic_param_axes(cell.trees()[0])
    assert port_axes(got) == jax_axes(jax_generic(jcell.abstract_args[0]))
    assert jax.tree_util.tree_structure(jcell.abstract_args[0]).num_leaves == len(port_axes(got))


@pytest.mark.parametrize("shape", GNN_SHAPES)
def test_gnn_abstract_batch_equals_the_reference(shape):
    from repro.launch.steps import GNN_SHAPES as JAX_GNN_SHAPES
    from repro.launch.steps import gnn_abstract_batch as jax_batch

    from repro_torch.launch.steps import GNN_SHAPES as PORT_GNN_SHAPES
    from repro_torch.launch.steps import gnn_abstract_batch

    assert PORT_GNN_SHAPES == JAX_GNN_SHAPES
    for pos in (False, True):
        for per_graph in (False, True):
            kw = dict(d_edge=4, d_target=3, with_positions=pos, per_graph_target=per_graph)
            got, got_axes = gnn_abstract_batch(PORT_GNN_SHAPES[shape], **kw)
            want, want_axes = jax_batch(JAX_GNN_SHAPES[shape], **kw)
            assert port_shapes(got) == jax_shapes(want)
            assert port_axes(got_axes) == jax_axes(want_axes)


def test_registry_equals_the_reference():
    """The counterparts of the reference's ``test_all_cells_constructible``
    and ``test_paper_graph_engine_cells``."""
    import repro.configs as jax_configs

    import repro_torch.configs as configs

    assert configs.ASSIGNED_ARCHS == jax_configs.ASSIGNED_ARCHS
    cells = configs.all_cells()
    assert cells == jax_configs.all_cells() and len(cells) == 40
    for arch in configs.ASSIGNED_ARCHS + ["paper-graph-engine"]:
        assert configs.arch_shapes(arch) == jax_configs.arch_shapes(arch)
        assert configs.get_arch(arch).ARCH_ID == arch
    for arch, shape in cells:
        cell = configs.get_arch(arch).make_cell(shape)
        assert cell.abstract_args and cell.kind in ("train", "prefill", "decode", "serve", "score")
    mod = configs.get_arch("paper-graph-engine")
    assert (mod.FAMILY, mod.V, mod.E) == ("graph", 1 << 26, 1 << 30)
    for shape in mod.SHAPES:
        assert mod.make_cell(shape).meta["n_edges"] == 1 << 30
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("no-such-arch")
