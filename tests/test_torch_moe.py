"""The port's MoE block (``layers/moe.py``) and MoE serving against the JAX
package on the CPU, on the same numpy-seeded inputs and weights: the router,
the capacity rule and the auxiliary loss; both dispatches (the gather one
with one group, four, and a token count no multiple of the groups), with
and without the dense residual, when capacity binds (a capacity factor of
0.5, one expert that every token wants) and when it does not, and on ties
(two equal router columns and repeated tokens); ``moe_block`` in float32
and bf16; and on the grok-1 and arctic smoke configs the weight converter,
prefill, a decode chain with mixed ``advance``, the serving engine's tokens
and plans, the configs, the registry and the launcher."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import XEON_E5_2660V4 as JAX_XEON  # noqa: E402
from repro.layers import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.layers import moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

MOE_ARCHS = ["grok-1-314b", "arctic-480b"]
# float32: the LM tests' tolerances (the same float32 math up to the
# products' blocking)
RTOL, ATOL = 1e-5, 1e-6
# bf16: the LM tests' bf16 tolerances (tests/test_torch_transformer.py): one
# bf16 step where the two packages' float32 sums round to neighbours
BF16_RTOL, BF16_ATOL = 2**-6, 4e-3
T, D, F, E = 24, 32, 48, 4

# the reference's dispatch functions, jitted (pure functions) so the many
# cases below run in seconds
J_BLOCK = jax.jit(jmoe.moe_block, static_argnums=2)
J_ROUTE = jax.jit(lambda p, x, k: jax.lax.top_k(jmoe.router_probs(p, x), k), static_argnums=2)


def _case(case: str, seed: int, residual: bool):
    """Weights {w_router [D,E], wi_gate/wi_up [E,D,F], wo [E,F,D], residual}
    and tokens x [T, D] for one routing case, and its capacity factor:
    ``free`` (no pair dropped), ``cf_half`` (capacity factor 0.5), ``skew``
    (every token's first choice is expert 0), ``tie`` (router columns 1 and
    2 equal, and half the tokens one repeated token that picks exactly
    those two: equal router probabilities and equal positive gates at the
    capacity edge)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)  # noqa: E731
    w = {"w_router": n(D, E), "wi_gate": n(E, D, F), "wi_up": n(E, D, F), "wo": n(E, F, D)}
    if residual:
        w["residual"] = {"wi_gate": n(D, F), "wi_up": n(D, F), "wo": n(F, D)}
    x = rng.standard_normal((T, D)).astype(np.float32)
    cf = 0.5 if case in ("cf_half", "tie") else 1.25
    if case == "skew":
        x[:, 0] = 3.0
        w["w_router"][0, 0] = 2.0
    elif case == "tie":
        w["w_router"][:, 2] = w["w_router"][:, 1]
        x[::2] = 4.0 * w["w_router"][:, 1] / np.linalg.norm(w["w_router"][:, 1])
    return w, x, cf


def _cfg(dispatch: str, groups: int, cf: float, residual: bool):
    kw = dict(num_experts=E, top_k=2, capacity_factor=cf, dispatch=dispatch, dispatch_groups=groups,
              dense_residual=residual)
    return jmoe.MoEConfig(**kw), moe.MoEConfig(**kw)


def _jax(tree, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype=torch.float32):
    return {k: _torch(v, dtype) if isinstance(v, dict) else torch.from_numpy(v).to(dtype) for k, v in tree.items()}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=rtol, atol=atol)


def _dropped(gate_idx: np.ndarray, c: int) -> int:
    """(token, choice) pairs past the capacity, by the reference's rule."""
    onehot = np.eye(E, dtype=np.int64)[gate_idx].reshape(-1, E)
    pos = ((np.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    return int((pos >= c).sum())


CASES = ["free", "cf_half", "skew", "tie"]
DISPATCHES = [("dense", 1), ("gather", 1), ("gather", 4), ("gather", 5)]  # 24 % 5 != 0: one group


# ---------------- router, capacity, aux loss ----------------

@pytest.mark.parametrize("case", CASES)
def test_router_and_routing_equal_jax(case):
    """Probabilities within float32 rounding, top-2 experts *equal* (ties in
    index order), the dense keep rule equal, and the case as named."""
    w, x, cf = _case(case, 1, False)
    jcfg, cfg = _cfg("dense", 1, cf, False)
    jp, tp = _jax(w), _torch(w)
    probs = moe.router_probs(tp, torch.from_numpy(x))
    _close(probs, jmoe.router_probs(jp, jnp.asarray(x)))
    _, gate_vals, gate_idx = moe.route(tp, torch.from_numpy(x), cfg)
    jvals, jidx = J_ROUTE(jp, jnp.asarray(x), 2)
    assert gate_idx.tolist() == np.asarray(jidx).tolist()
    _close(gate_vals, jvals / jvals.sum(-1, keepdims=True))
    c = moe._capacity(T, cfg)
    keep = moe.dense_positions(gate_idx, E) < c
    assert int((~keep).sum()) == _dropped(np.asarray(jidx), c)
    if case == "free":
        assert bool(keep.all())
    else:
        assert not bool(keep.all())
    if case == "skew":
        assert (gate_idx[:, 0] == 0).all()
    if case == "tie":
        assert torch.equal(probs[:, 1], probs[:, 2])
        assert np.array_equal(np.asarray(jmoe.router_probs(jp, jnp.asarray(x)))[:, 1],
                              np.asarray(jmoe.router_probs(jp, jnp.asarray(x)))[:, 2])
        assert gate_idx[0].tolist() == [1, 2] and float(gate_vals[0, 0]) == 0.5
        # the gather's top-C for expert 1 cuts through equal positive gates
        gate_1 = (gate_vals * (gate_idx == 1)).sum(1)
        ranked = torch.sort(gate_1, descending=True).values
        assert ranked[c - 1] == ranked[c] == 0.5


def test_router_ignores_tf32_settings():
    """The router's product runs in IEEE float32 whatever the caller set,
    and leaves the caller's setting as it was."""
    w, x, _ = _case("free", 2, False)
    want = moe.router_probs(_torch(w), torch.from_numpy(x))
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        assert torch.equal(moe.router_probs(_torch(w), torch.from_numpy(x)), want)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)


def test_capacity_equals_jax():
    for tokens in (1, 3, 7, 8, 24, 120, 2048, 16384):
        for e, k, cf in ((4, 2, 1.25), (8, 2, 1.25), (128, 2, 1.25), (4, 2, 0.5), (8, 1, 2.0)):
            jcfg = jmoe.MoEConfig(num_experts=e, top_k=k, capacity_factor=cf)
            cfg = moe.MoEConfig(num_experts=e, top_k=k, capacity_factor=cf)
            assert moe._capacity(tokens, cfg) == jmoe._capacity(tokens, jcfg)
    # the served widths: grok at B = 8 decode and 8 x 2048 prefill, arctic's
    grok, arctic = get_arch("grok-1-314b").make_config().moe, get_arch("arctic-480b").make_config().moe
    assert [moe._capacity(t, grok) for t in (8, 16384)] == [2, 5120]
    assert [moe._capacity(t, arctic) for t in (8, 16384)] == [1, 320]


@pytest.mark.parametrize("case", ["free", "skew", "tie"])
def test_aux_loss_equals_jax(case):
    w, x, cf = _case(case, 3, False)
    jp, tp = _jax(w), _torch(w)
    probs, _, gate_idx = moe.route(tp, torch.from_numpy(x), moe.MoEConfig(num_experts=E))
    jprobs = jmoe.router_probs(jp, jnp.asarray(x))
    _, jidx = jax.lax.top_k(jprobs, 2)
    _close(moe._aux_loss(probs, gate_idx, E), jmoe._aux_loss(jprobs, jidx, E))


# ---------------- the dispatches and the block ----------------

@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dispatch,groups", DISPATCHES)
@pytest.mark.parametrize("case", CASES)
def test_moe_block_matches_jax_float32(case, dispatch, groups, residual):
    w, x, cf = _case(case, 4, residual)
    jcfg, cfg = _cfg(dispatch, groups, cf, residual)
    xb = x.reshape(2, T // 2, D)
    jout, jaux = J_BLOCK(_jax(w), jnp.asarray(xb), jcfg)
    out, aux = moe.moe_block(_torch(w), torch.from_numpy(xb), cfg)
    assert out.shape == (2, T // 2, D) and out.dtype == torch.float32
    _close(out, jout)
    _close(aux, jaux)


@pytest.mark.parametrize("dispatch,groups", DISPATCHES)
@pytest.mark.parametrize("case", CASES)
def test_dispatch_functions_match_jax(case, dispatch, groups):
    """The dispatch functions on [T, D] directly, in float32."""
    w, x, cf = _case(case, 5, False)
    jcfg, cfg = _cfg(dispatch, groups, cf, False)
    jfn = jmoe.moe_dense_dispatch if dispatch == "dense" else jmoe.moe_gather_dispatch
    fn = moe.moe_dense_dispatch if dispatch == "dense" else moe.moe_gather_dispatch
    jout, jaux = jfn(_jax(w), jnp.asarray(x), jcfg)
    out, aux = fn(_torch(w), torch.from_numpy(x), cfg)
    _close(out, jout)
    _close(aux, jaux)


@pytest.mark.parametrize("dispatch,groups", DISPATCHES)
@pytest.mark.parametrize("case", CASES)
def test_moe_block_matches_jax_bf16(case, dispatch, groups):
    """bf16 weights and tokens (the reference casts both to ``cfg.dtype``),
    with the dense residual: the combine sums at most k products and rounds
    once (dense), or rounds each product and then each add (gather), as the
    reference does. The reference runs op by op here: under ``jax.jit`` XLA
    may skip the roundings between fused bf16 operations (its default
    ``xla_allow_excess_precision``), which moves half the outputs by a
    bf16 step or two; op by op, each rounds as written."""
    w, x, cf = _case(case, 6, True)
    jcfg, cfg = _cfg(dispatch, groups, cf, True)
    xb = x.reshape(3, T // 3, D)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), _jax(w))
    jout, _ = jmoe.moe_block(jp, jnp.asarray(xb, jnp.bfloat16), jcfg)
    out, _ = moe.moe_block(_torch(w, torch.bfloat16), torch.from_numpy(xb).bfloat16(), cfg)
    assert out.dtype == torch.bfloat16
    _close(out, jout, BF16_RTOL, BF16_ATOL)


def test_dispatches_agree_on_tokens_that_fit():
    """Without drops, dense and gather compute the same function."""
    w, x, cf = _case("free", 7, False)
    _, dense = _cfg("dense", 1, cf, False)
    _, gather = _cfg("gather", 1, cf, False)
    a, _ = moe.moe_dense_dispatch(_torch(w), torch.from_numpy(x), dense)
    b, _ = moe.moe_gather_dispatch(_torch(w), torch.from_numpy(x), gather)
    torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


# ---------------- the MoE smoke configs ----------------

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, seed=0, **moe_kw):
    jcfg, cfg = jax_get_arch(arch).make_smoke_config(), get_arch(arch).make_smoke_config()
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    params = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    model = tf.TransformerLM(cfg, seed=seed, device="cpu")
    model.load_state_dict(tf.params_from_jax(cfg, _np_tree(params)))
    return jcfg, params, cfg, model


def _cache_close(got, want):
    _close(got["k"], want["k"])
    _close(got["v"], want["v"])
    assert got["len"].tolist() == np.asarray(want["len"]).tolist()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_from_jax_carries_every_moe_tensor(arch):
    jcfg, params, cfg, model = _pair(arch, seed=3)
    state = model.state_dict()
    layers = _np_tree(params)["layers"]
    flat = {}
    for i in range(cfg.n_layers):
        for group in ("ln1", "ln2", "attn"):
            for name, stacked in layers[group].items():
                flat[f"layers.{i}.{group}.{name}"] = stacked[i]
        for name, stacked in layers["moe"].items():
            if name == "residual":
                for rname, rstacked in stacked.items():
                    flat[f"layers.{i}.moe.residual.{rname}"] = rstacked[i]
            else:
                flat[f"layers.{i}.moe.{name}"] = stacked[i]
    assert ("residual" in layers["moe"]) == (arch == "arctic-480b") == cfg.moe.dense_residual
    assert "mlp" not in layers and not any(".mlp." in n for n in state)
    layer_state = {n: v for n, v in state.items() if n.startswith("layers.")}
    assert set(layer_state) == set(flat)
    for name, want in flat.items():
        assert tuple(state[name].shape) == want.shape, name  # [E,D,F], [E,F,D] kept
        assert np.array_equal(state[name].numpy(), want), name
    assert sum(t.numel() for t in state.values()) == cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dispatch", ["dense", "gather"])
@pytest.mark.parametrize("s", [5, 32])
def test_moe_prefill_matches_jax(arch, dispatch, s):
    """Gather at s = 32 runs 3 x 32 = 96 tokens in the smoke config's 16
    groups; at s = 5 (15 tokens) in one group."""
    jcfg, params, cfg, model = _pair(arch, seed=s, dispatch=dispatch)
    toks = np.random.default_rng(s).integers(0, cfg.vocab, (3, s)).astype(np.int32)
    jl, jc = jtf.prefill(jcfg, params, jnp.asarray(toks), s + 4)
    logits, cache = tf.prefill(cfg, model, torch.from_numpy(toks), s + 4)
    _close(logits, jl)
    _cache_close(cache, jc)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_with_binding_capacity_matches_jax(arch):
    """Capacity factor 0.5: a quarter of the (token, choice) pairs or more
    pass through the residual only."""
    jcfg, params, cfg, model = _pair(arch, seed=9, capacity_factor=0.5)
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    jl, jc = jtf.prefill(jcfg, params, jnp.asarray(toks), 24)
    logits, cache = tf.prefill(cfg, model, torch.from_numpy(toks), 24)
    _close(logits, jl)
    _cache_close(cache, jc)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_chain_matches_jax(arch):
    """Prefill 5 of 8 positions, then 6 steps with mixed ``advance`` past the
    cache's end. Three slots at capacity 1 per expert (int(3·2·1.25/4)):
    slots that do not advance still route and compete for it."""
    jcfg, params, cfg, model = _pair(arch, seed=11)
    assert moe._capacity(3, cfg.moe) == 1
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (3, 5)).astype(np.int32)
    jl, jc = jtf.prefill(jcfg, params, jnp.asarray(toks), 8)
    _, cache = tf.prefill(cfg, model, torch.from_numpy(toks), 8)
    for step in range(6):
        tok = rng.integers(0, cfg.vocab, (3, 1)).astype(np.int32)
        adv = np.array([True, step % 2 == 0, False])
        jl, jc = jtf.decode_step(jcfg, params, jnp.asarray(tok), jc, advance=jnp.asarray(adv))
        logits, cache = tf.decode_step(cfg, model, torch.from_numpy(tok), cache, advance=torch.from_numpy(adv))
        _close(logits, jl)
        _cache_close(cache, jc)
    assert cache["len"].tolist() == [11, 8, 5]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_serving_engine_matches_jax(arch, monkeypatch):
    """The same requests through both engines under the Xeon model: the same
    tokens request by request, the same plans, the same cache."""
    jcfg, params, cfg, model = _pair(arch, seed=7)
    monkeypatch.setattr(jtf, "decode_step", jax.jit(jtf.decode_step, static_argnums=0))
    rng = np.random.default_rng(7)
    reqs = [(rid, rng.integers(1, cfg.vocab, size=rng.integers(3, 7)).astype(np.int32)) for rid in range(5)]
    jeng = JaxServingEngine(jcfg, params, max_batch=3, max_len=16, hw=JAX_XEON)
    eng = ServingEngine(cfg, model, max_batch=3, max_len=16, hw=core.XEON_E5_2660V4)
    jr = [JaxRequest(rid, p, max_new_tokens=4) for rid, p in reqs]
    tr = [Request(rid, p, max_new_tokens=4) for rid, p in reqs]
    for a, b in zip(jr, tr):
        jeng.submit(a)
        eng.submit(b)
    assert jeng.run_until_drained() == eng.run_until_drained() == 20
    assert [r.generated for r in tr] == [[int(t) for t in r.generated] for r in jr]
    assert eng.plans == jeng.plans
    assert eng.cache["len"].tolist() == np.asarray(jeng.cache["len"]).tolist()
    _close(eng.cache["k"], jeng.cache["k"])


def test_serve_launcher_runs_grok_on_cpu(capsys):
    out = serve.main(["--arch", "grok-1-314b", "--device", "cpu", "--requests", "3", "--max-new-tokens", "2"])
    assert out["tokens"] == 6 and sum(out["plans"].values()) >= 2
    assert "served 3 requests, 6 tokens" in capsys.readouterr().out


# ---------------- configs ----------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dispatch", ["dense", "gather"])
def test_moe_configs_equal_the_reference(arch, dispatch):
    mod, jmod = get_arch(arch), jax_get_arch(arch)
    assert (mod.ARCH_ID, mod.FAMILY, mod.OPTIMIZER, mod.SHAPES) == (
        jmod.ARCH_ID, jmod.FAMILY, jmod.OPTIMIZER, jmod.SHAPES)
    pairs = [(mod.make_config(dispatch), jmod.make_config(dispatch)),
             (mod.make_config(dispatch, 4), jmod.make_config(dispatch, 4)),
             (mod.make_smoke_config(), jmod.make_smoke_config())]
    for got, want in pairs:
        no_dtypes = {"dtype": None, "param_dtype": None}
        assert isinstance(got.moe, moe.MoEConfig)
        assert dataclasses.asdict(got) | no_dtypes == dataclasses.asdict(want) | no_dtypes
        assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
        assert (got.dh, got.q_per_kv, got.param_count(), got.active_param_count()) == (
            want.dh, want.q_per_kv, want.param_count(), want.active_param_count())


def test_moe_config_fields_equal_the_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(moe.MoEConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(jmoe.MoEConfig)]
    with pytest.raises(dataclasses.FrozenInstanceError):
        moe.MoEConfig(num_experts=4).top_k = 1


def test_moe_full_widths():
    """The widths chip_smoke.py serves, and what one layer weighs in bf16."""
    grok, arctic = get_arch("grok-1-314b").make_config(), get_arch("arctic-480b").make_config()
    assert (grok.d_model, grok.n_heads, grok.n_kv_heads, grok.dh, grok.q_per_kv, grok.d_ff, grok.vocab) == (
        6144, 48, 8, 128, 6, 32768, 131072)
    assert (arctic.d_model, arctic.n_heads, arctic.n_kv_heads, arctic.dh, arctic.q_per_kv, arctic.d_ff,
            arctic.vocab) == (7168, 56, 8, 128, 7, 4864, 32000)
    layer = lambda c: (c.param_count() - 2 * c.vocab * c.d_model - c.d_model) // c.n_layers  # noqa: E731
    assert round(2 * layer(grok) / 1e9, 2) == 9.84 and round(2 * layer(arctic) / 1e9, 2) == 27.22
    small = dataclasses.replace(get_arch("arctic-480b").make_smoke_config(), n_layers=1)
    model = tf.TransformerLM(small, seed=0, device="cpu")
    assert set(model.layers[0].moe.keys()) == {"w_router", "wi_gate", "wi_up", "wo", "residual"}
    assert model.layers[0].moe["residual"]["wo"].shape == (small.d_ff, small.d_model)
