"""The port's LM serving slice against the JAX package on the CPU, on the same
weights and tokens: the weight converter, ``prefill`` (logits and cache), a
chain of ``decode_step``s with mixed ``advance`` up to and past the cache's
end, ``ServingEngine``'s tokens and plans, a bf16 case, the configs, the
registry and ``LM_SHAPES``, and the launcher."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import XEON_E5_2660V4 as JAX_XEON  # noqa: E402
from repro.launch.steps import LM_SHAPES as JAX_LM_SHAPES  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_arch  # noqa: E402
from repro_torch.kernels.attention import flash_attention_cuda, flash_attention_plain  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import LM_SHAPES  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

LM_ARCHS = ["tinyllama-1.1b", "stablelm-1.6b", "granite-34b"]
# float32 smoke configs: the same float32 math up to the products' blocking
# and the attention's block order; logits of ~0.1 agree to ~1e-7 measured
RTOL, ATOL = 1e-5, 1e-6
# bf16 smoke config: every product rounds to bf16 (2**-8 relative) in both
# packages, at places where their float32 sums differ in the last bits, so
# single activations can sit one bf16 step apart and carry through two
# layers. The bf16 cases catch a result left in the wrong type or a cast
# that moves whole activations; at these widths a softmax computed in bf16
# hides in that noise, and test_torch_attention.py's bf16 flash case (an
# 8-bit mantissa against the reference's float32 scores) catches it there.
BF16_RTOL, BF16_ATOL = 2**-6, 4e-3  # measured: one bf16 step (0.002 at logits of 0.47)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, seed=0, bf16=False):
    """The JAX config and parameters, and the port's config and model holding
    the same numbers; ``bf16`` computes in bfloat16 (float32 master weights)."""
    jcfg, cfg = jax_get_arch(arch).make_smoke_config(), get_arch(arch).make_smoke_config()
    if bf16:
        jcfg, cfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16), dataclasses.replace(cfg, dtype=torch.bfloat16)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    model = tf.TransformerLM(cfg, seed=seed, device="cpu")
    model.load_state_dict(tf.params_from_jax(cfg, _np_tree(params)))
    return jcfg, params, cfg, model


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=rtol, atol=atol)


def _cache_close(got, want, rtol=RTOL, atol=ATOL):
    _close(got["k"], want["k"], rtol, atol)
    _close(got["v"], want["v"], rtol, atol)
    assert got["len"].dtype == torch.int32
    assert got["len"].tolist() == np.asarray(want["len"]).tolist()


# ---------------- weights ----------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_params_from_jax_carries_every_tensor(arch):
    jcfg, params, cfg, model = _pair(arch, seed=3)
    state = model.state_dict()
    tree = _np_tree(params)
    flat = {"embed": tree["embed"], "lm_head": tree["lm_head"], "final_norm.scale": tree["final_norm"]["scale"]}
    for i in range(cfg.n_layers):
        for group in ("ln1", "ln2", "attn", "mlp"):
            for name, stacked in tree["layers"][group].items():
                flat[f"layers.{i}.{group}.{name}"] = stacked[i]
    assert set(state) == set(flat)
    for name, want in flat.items():
        assert tuple(state[name].shape) == want.shape, name  # [D,H,Dh], [H,Dh,D] kept
        assert np.array_equal(state[name].numpy(), want), name
    n = sum(t.numel() for t in state.values())
    assert n == cfg.param_count() == jcfg.param_count()


def test_weights_are_cast_once_to_the_compute_dtype():
    jcfg, params, cfg, model = _pair("tinyllama-1.1b", bf16=True)
    assert cfg.dtype == torch.bfloat16
    assert model.layers[0].attn["wq"].dtype == torch.bfloat16 and model.embed.dtype == torch.bfloat16
    assert model.layers[0].ln1["scale"].dtype == torch.float32  # norms stay in param_dtype
    want = np.asarray(params["layers"]["attn"]["wq"][1].astype(jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(model.layers[1].attn["wq"].float().numpy(), want)  # the reference's per-call cast


def test_model_init_is_seeded_and_refuses_cpu_without_device(monkeypatch):
    cfg = get_arch("granite-34b").make_smoke_config()
    a, b, c = (tf.TransformerLM(cfg, seed=s, device="cpu") for s in (4, 4, 5))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert not torch.equal(a.embed, c.embed)
    assert abs(float(a.embed.std()) - 0.02) < 0.002
    assert not any(p.requires_grad for p in a.parameters())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_cache(cfg, 1, 4)
    # an MoE config builds its experts in place of the MLP
    moe_cfg = get_arch("grok-1-314b").make_smoke_config()
    moe_model = tf.TransformerLM(moe_cfg, seed=4, device="cpu")
    assert not hasattr(moe_model.layers[0], "mlp")
    assert moe_model.layers[0].moe["wi_gate"].shape == (moe_cfg.moe.num_experts, moe_cfg.d_model, moe_cfg.d_ff)


# ---------------- prefill and decode ----------------

@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("s", [5, 40])
def test_prefill_matches_jax(arch, s):
    """s=40 spans three of the smoke config's 16-key blocks, the last ragged."""
    jcfg, params, cfg, model = _pair(arch, seed=s)
    toks = np.random.default_rng(s).integers(0, cfg.vocab, (3, s)).astype(np.int32)
    jl, jc = jtf.prefill(jcfg, params, jnp.asarray(toks), s + 4)
    before = flash_attention_cuda.launches
    logits, cache = tf.prefill(cfg, model, torch.from_numpy(toks), s + 4)
    assert flash_attention_cuda.launches == before  # CPU tensors: the plain version
    assert logits.shape == (3, cfg.vocab) and logits.dtype == torch.float32
    _close(logits, jl)
    _cache_close(cache, jc)
    # the attention argument: the kernel's plain version gives the same numbers
    plain = lambda q, k, v: flash_attention_plain(q, k, v, block_kv=cfg.block_kv)  # noqa: E731
    logits2, cache2 = tf.prefill(cfg, model, torch.from_numpy(toks), s + 4, attention=plain)
    assert torch.equal(logits2, logits) and torch.equal(cache2["k"], cache["k"])


def test_prefill_refuses_a_short_cache():
    _, _, cfg, model = _pair("tinyllama-1.1b")
    with pytest.raises(ValueError, match="max_len"):
        tf.prefill(cfg, model, torch.zeros(1, 9, dtype=torch.int32), 8)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_chain_matches_jax_past_the_cache_end(arch):
    """Prefill 5 of 8 positions, then 6 steps with mixed ``advance``: slot 0
    advances every step and reaches ``len == max_len`` at step 3 (the
    reference's gather clamps to the last entry and its scatter is dropped),
    slot 1 every other step, slot 2 never (it rewrites its entry)."""
    jcfg, params, cfg, model = _pair(arch, seed=11)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (3, 5)).astype(np.int32)
    jl, jc = jtf.prefill(jcfg, params, jnp.asarray(toks), 8)
    _, cache = tf.prefill(cfg, model, torch.from_numpy(toks), 8)
    lens = []
    for step in range(6):
        tok = rng.integers(0, cfg.vocab, (3, 1)).astype(np.int32)
        adv = np.array([True, step % 2 == 0, False])
        k_before = cache["k"].clone()
        jl, jc = jtf.decode_step(jcfg, params, jnp.asarray(tok), jc, advance=jnp.asarray(adv))
        logits, cache = tf.decode_step(cfg, model, torch.from_numpy(tok), cache, advance=torch.from_numpy(adv))
        _close(logits, jl)
        _cache_close(cache, jc)
        assert torch.equal(cache["k"][:, 2], k_before[:, 2])  # never advanced: untouched
        if step >= 3:
            assert torch.equal(cache["k"][:, 0], k_before[:, 0])  # past the end: scatter dropped
        lens.append(cache["len"].tolist())
    assert lens[-1] == [11, 8, 5] and [l[0] for l in lens] == [6, 7, 8, 9, 10, 11]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_into_a_float32_cache_matches_jax(arch):
    """The engine's cache: float32 storage under a bf16 model, from empty."""
    jcfg, params, cfg, model = _pair(arch, seed=2, bf16=True)
    jc = jtf.init_cache(jcfg, 2, 6, dtype=jnp.float32)
    cache = tf.init_cache(cfg, 2, 6, dtype=torch.float32, device="cpu")
    assert cache["k"].shape == (cfg.n_layers, 2, 6, cfg.n_kv_heads, cfg.dh)
    rng = np.random.default_rng(2)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jtf.decode_step(jcfg, params, jnp.asarray(tok), jc)
        logits, cache = tf.decode_step(cfg, model, torch.from_numpy(tok), cache)
        assert logits.dtype == torch.bfloat16 and cache["k"].dtype == torch.float32
        _close(logits, jl, BF16_RTOL, BF16_ATOL)
        _cache_close(cache, jc, BF16_RTOL, BF16_ATOL)


def test_bf16_prefill_matches_jax():
    jcfg, params, cfg, model = _pair("tinyllama-1.1b", seed=5, bf16=True)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    jl, jc = jtf.prefill(jcfg, params, jnp.asarray(toks), 24)
    logits, cache = tf.prefill(cfg, model, torch.from_numpy(toks), 24)
    assert logits.dtype == torch.bfloat16 and cache["k"].dtype == torch.bfloat16
    _close(logits, jl, BF16_RTOL, BF16_ATOL)
    _cache_close(cache, jc, BF16_RTOL, BF16_ATOL)


# ---------------- the serving engine ----------------

def _requests(vocab, n, rng):
    return [(rid, rng.integers(1, vocab, size=rng.integers(3, 7)).astype(np.int32)) for rid in range(n)]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serving_engine_matches_jax(arch, monkeypatch):
    """The same requests through both engines under the Xeon model: the same
    tokens, the same plans. The reference's ``decode_step`` is jitted here
    (it is a pure function) so the replayed prompts run in seconds."""
    jcfg, params, cfg, model = _pair(arch, seed=7)
    monkeypatch.setattr(jtf, "decode_step", jax.jit(jtf.decode_step, static_argnums=0))
    reqs = _requests(cfg.vocab, 5, np.random.default_rng(7))
    jeng = JaxServingEngine(jcfg, params, max_batch=3, max_len=16, hw=JAX_XEON)
    eng = ServingEngine(cfg, model, max_batch=3, max_len=16, hw=core.XEON_E5_2660V4)
    for rid, prompt in reqs:
        jeng.submit(JaxRequest(rid, prompt, max_new_tokens=4))
        eng.submit(Request(rid, prompt, max_new_tokens=4))
    assert jeng.run_until_drained() == eng.run_until_drained() == 20
    assert eng.plans == jeng.plans and all(isinstance(w, int) for w in eng.plans)
    assert eng.cache["k"].dtype == torch.float32
    assert eng.cache["len"].tolist() == np.asarray(jeng.cache["len"]).tolist()
    _close(eng.cache["k"], jeng.cache["k"])
    assert not eng.queue and not any(eng.slots)


def test_serving_engine_tokens_match_jax(monkeypatch):
    """Each request's generated tokens, compared request by request."""
    jcfg, params, cfg, model = _pair("tinyllama-1.1b", seed=8)
    monkeypatch.setattr(jtf, "decode_step", jax.jit(jtf.decode_step, static_argnums=0))
    reqs = _requests(cfg.vocab, 3, np.random.default_rng(8))
    jeng = JaxServingEngine(jcfg, params, max_batch=2, max_len=12, hw=JAX_XEON)
    eng = ServingEngine(cfg, model, max_batch=2, max_len=12, hw=core.XEON_E5_2660V4)
    jr = [JaxRequest(rid, p, max_new_tokens=3) for rid, p in reqs]
    tr = [Request(rid, p, max_new_tokens=3) for rid, p in reqs]
    for a, b in zip(jr, tr):
        jeng.submit(a)
        eng.submit(b)
    jeng.run_until_drained()
    eng.run_until_drained()
    assert [r.generated for r in tr] == [[int(t) for t in r.generated] for r in jr]
    assert all(r.done for r in tr) and eng.plans == jeng.plans


def test_serving_engine_needs_a_hardware_model():
    _, _, cfg, model = _pair("tinyllama-1.1b")
    with pytest.raises(TypeError):
        ServingEngine(cfg, model, max_batch=2, max_len=8)  # noqa


def test_serve_launcher_runs_on_cpu(capsys):
    out = serve.main(["--device", "cpu", "--requests", "3", "--max-new-tokens", "2"])
    assert out["tokens"] == 6 and sum(out["plans"].values()) >= 2
    assert "served 3 requests, 6 tokens" in capsys.readouterr().out


# ---------------- configs, registry, shapes ----------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_equal_the_reference(arch):
    mod, jmod = get_arch(arch), jax_get_arch(arch)
    assert (mod.ARCH_ID, mod.FAMILY, mod.OPTIMIZER, mod.SHAPES) == (
        jmod.ARCH_ID, jmod.FAMILY, jmod.OPTIMIZER, jmod.SHAPES)
    for make in ("make_config", "make_smoke_config"):
        got, want = getattr(mod, make)(), getattr(jmod, make)()
        no_dtypes = {"dtype": None, "param_dtype": None}
        assert dataclasses.asdict(got) | no_dtypes == dataclasses.asdict(want) | no_dtypes
        assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
        assert got.param_dtype == torch.float32
        assert (got.dh, got.q_per_kv, got.param_count(), got.active_param_count()) == (
            want.dh, want.q_per_kv, want.param_count(), want.active_param_count())


def test_smoke_configs_cover_mha_gqa_and_one_kv_head():
    cfgs = {a: get_arch(a).make_smoke_config() for a in LM_ARCHS}
    assert [(c.n_heads, c.n_kv_heads) for c in cfgs.values()] == [(4, 2), (4, 2), (4, 1)]
    full = {a: get_arch(a).make_config() for a in LM_ARCHS}
    assert [f.q_per_kv for f in full.values()] == [8, 1, 48]
    tiny = full["tinyllama-1.1b"]
    assert (tiny.n_layers, tiny.d_model, tiny.n_heads, tiny.n_kv_heads, tiny.dh, tiny.d_ff, tiny.vocab) == (
        22, 2048, 32, 4, 64, 5632, 32000)
    assert tiny.param_count() == 1_100_048_384  # 4.4 GB in float32


def test_lm_shapes_equal_the_reference():
    assert LM_SHAPES == JAX_LM_SHAPES


def test_registry_holds_the_lm_archs():
    # the reference's order (repro.configs.registry)
    assert ASSIGNED_ARCHS == ["granite-34b", "tinyllama-1.1b", "stablelm-1.6b", "grok-1-314b", "arctic-480b",
                              "meshgraphnet", "pna", "graphcast", "schnet", "two-tower-retrieval"]
    for arch in LM_ARCHS + ["grok-1-314b", "arctic-480b"]:
        assert get_arch(arch).ARCH_ID == arch
    assert get_arch("arctic-480b").make_config().moe.dense_residual
    assert get_arch("paper-graph-engine").ARCH_ID == "paper-graph-engine"
