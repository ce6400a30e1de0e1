"""The dry-run slice's cell programs against the JAX package's: for every
assigned cell, the graph engine's two and the reference dry-run's variants
(MoE gather dispatch, GraphCast owner-blocked, sequence parallel), the
name, kind, donated arguments, meta entries, abstract-argument leaves
(path, shape, dtype; a model argument as its parameter tree), logical axes
and sharding plans on both production layouts (the reference's planned on
``AbstractMesh``, no devices) are equal, exactly; and each cell's trip-1
variant traced on ``meta`` gives the leaves of ``jax.eval_shape`` of the
reference's step on its abstract arguments."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_cells import (  # noqa: E402
    VARIANTS,
    abstract_meshes,
    all_cell_ids,
    jax_axes,
    jax_plan,
    jax_shapes,
    make_cells,
    make_trip1,
    port_axes,
    port_shapes,
)

CELL_IDS = all_cell_ids()


def _id(case) -> str:
    arch, shape, *kw = case
    return f"{arch}:{shape}" + (":" + ",".join(f"{k}={v}" for k, v in kw[0].items()) if kw else "")


def _hold_cell(arch: str, shape: str, kwargs: dict):
    from repro.sharding.rules import default_rules as jax_rules

    from repro_torch.sharding.rules import default_rules

    ref, got = make_cells(arch, shape, **kwargs)
    assert (got.name, got.kind, got.donate_argnums) == (ref.name, ref.kind, ref.donate_argnums)
    assert got.meta == ref.meta
    assert len(got.abstract_args) == len(ref.abstract_args) == len(got.axes_trees) == len(ref.axes_trees)
    for a_got, a_ref in zip(got.trees(), ref.abstract_args):
        assert port_shapes(a_got) == jax_shapes(a_ref)
    for ax_got, ax_ref in zip(got.axes_trees, ref.axes_trees):
        assert port_axes(ax_got) == jax_axes(ax_ref)
    for jmesh, mesh in abstract_meshes():
        jr, r = jax_rules(jmesh), default_rules(mesh)
        jr.update(ref.meta.get("rules_override", {}))
        r.update(got.meta.get("rules_override", {}))
        assert r == jr
        for p_got, p_ref in zip(got.shardings(mesh, r), ref.shardings(jmesh, jr)):
            assert port_axes(p_got) == jax_plan(p_ref)


@pytest.mark.parametrize("cell", CELL_IDS, ids=_id)
def test_cell_program_equals_the_reference(cell):
    _hold_cell(*cell, {})


@pytest.mark.parametrize("case", VARIANTS, ids=_id)
def test_cell_variant_equals_the_reference(case):
    _hold_cell(*case)


@pytest.mark.parametrize("cell", CELL_IDS, ids=_id)
def test_trip1_meta_trace_gives_the_reference_outputs(cell):
    import jax
    from repro.configs import get_arch as jax_arch

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_production_mesh

    arch, shape = cell
    ref = make_trip1(jax_arch(arch), shape)
    got = make_trip1(get_arch(arch), shape)
    want = jax.eval_shape(ref.step_fn, *ref.abstract_args)
    lowered = got.lower(make_production_mesh())
    assert port_shapes(lowered.out) == jax_shapes(want)
    # the trace left the cell's arguments as they were
    for a_got, a_ref in zip(got.trees(), ref.abstract_args):
        assert port_shapes(a_got) == jax_shapes(a_ref)
