"""The port's LM training slice against the JAX package on the CPU, on the
same numpy inputs and weights: the LR schedule, global-norm clipping, AdamW
and Adafactor (its factoring and update clipping on stacked layer leaves),
the int8 error-feedback compression, the attention's gradient, ``forward``
and ``loss_fn`` with their gradients on the smoke configs of all five LM
archs (the blocked attention above ``block_kv``, ``full_causal_attention``
at or below it), a bf16 case held against float32, and ``lm_train_step``
with microbatches and with remat on and off."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.tree_util import tree_flatten_with_path  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch.steps import lm_train_step as jax_lm_train_step  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.attention import FlashAttention, flash_attention_plain  # noqa: E402
from repro_torch.launch.steps import lm_train_step  # noqa: E402
from repro_torch.layers import attention  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

LM_ARCHS = ["tinyllama-1.1b", "stablelm-1.6b", "granite-34b", "grok-1-314b", "arctic-480b"]
# the optimizers on the same float32 inputs: the same elementwise formulas,
# with pow, sqrt and the means' sums free to differ in the last bit
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7
# float32 forward and backward of the smoke configs: the same math up to the
# products' blocking and the attention's order of sums (the backward's
# blocked softmax against XLA's autodiff of the online one); measured
# within 1e-6 of each gradient's largest entry
GRAD_RTOL = 1e-5
LOSS_RTOL = 1e-6
# the attention's gradient against jax.grad of the JAX twin, float32: the
# JAX package's flash tolerance (tests/test_kernels.py)
ATTN_GRAD_TOL = 2e-5
# a train step: loss and gradient norm within float32 noise; the parameters
# within 1e-6 after steps of lr 1e-2 (the optimizers are held exactly above;
# the steps' gradients differ by float32 summation order only), the
# moments as the gradients are (GRAD_RTOL of each leaf's largest entry)
STEP_RTOL = 1e-5
PARAM_ATOL = 1e-6
# bf16 against float32 (tests/test_torch_transformer.py, chip_smoke.py):
# the port's bf16 gradients may stray from float32 no further than the
# reference's bf16 gradients (run op by op: under jax.jit XLA skips bf16
# roundings between fused ops), up to these ratios of RMS and largest
# deviation per tensor
NOISE_RMS_RATIO, NOISE_MAX_RATIO = 1.25, 1.5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _tree_close(got, want, rtol, atol):
    """Every leaf of the port's tree against the reference's, by path."""
    paths = [jax.tree_util.keystr(p) for p, _ in tree_flatten_with_path(want)[0]]
    for path, g, w in zip(paths, tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.detach().float().numpy(), np.asarray(w, np.float32),
                                   rtol=rtol, atol=atol, err_msg=path)


def _tree_close_scaled(got, want, rel):
    """Every leaf within ``rel`` of that leaf's largest entry."""
    paths = [jax.tree_util.keystr(p) for p, _ in tree_flatten_with_path(want)[0]]
    for path, g, w in zip(paths, tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.detach().float().numpy(), w, rtol=0,
                                   atol=rel * float(np.abs(w).max()), err_msg=path)


def _grad_tree(rng, tree, scale=1.0):
    return jax.tree.map(lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32), tree)


# ---------------- LR schedule, clipping, optimizers, compression ----------------

@pytest.mark.parametrize("warmup,decay", [(0, 10), (1, 1), (3, 10), (100, 10_000), (20, 5)])
def test_lr_schedule_matches_jax(warmup, decay):
    kw = dict(lr=3e-4, warmup_steps=warmup, decay_steps=decay, min_lr_ratio=0.1)
    steps = np.array([0, 1, 2, 3, 5, 19, 20, 99, 100, 5000, 10_000, 20_000], np.int32)
    want = np.asarray(jax.vmap(lambda s: joptim.lr_schedule(joptim.OptimizerConfig(**kw), s))(steps))
    got = torch.stack([optim.lr_schedule(optim.OptimizerConfig(**kw), torch.tensor(s)) for s in steps])
    np.testing.assert_allclose(got.numpy(), want, rtol=OPT_RTOL, atol=0)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(1)
    tree = {"b": rng.normal(size=(7,)).astype(np.float32), "a": {"w": rng.normal(size=(3, 4)).astype(np.float32)}}
    want, wnorm = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
    got, gnorm = optim.clip_by_global_norm(_t_tree(tree), max_norm)
    np.testing.assert_allclose(float(gnorm), float(wnorm), rtol=OPT_RTOL)
    _tree_close(got, want, OPT_RTOL, OPT_ATOL)


def _params(rng):
    """A small tree in the LM's shape: a stacked [L, D] scale, a stacked
    [L, D, F] matrix, a [V, D] table and a 0-d leaf."""
    return {"layers": {"ln": {"scale": (1 + 0.1 * rng.normal(size=(2, 8))).astype(np.float32)},
                       "w": rng.normal(size=(2, 8, 6)).astype(np.float32)},
            "embed": rng.normal(size=(10, 8)).astype(np.float32),
            "bias": np.float32(rng.normal())}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("warmup,wd", [(2, 0.01), (0, 0.0)])
def test_optimizer_steps_match_jax(name, warmup, wd):
    rng = np.random.default_rng(2)
    cfg_kw = dict(name=name, lr=1e-2, warmup_steps=warmup, decay_steps=6, weight_decay=wd)
    jcfg, cfg = joptim.OptimizerConfig(**cfg_kw), optim.OptimizerConfig(**cfg_kw)
    params = _params(rng)
    jinit, jupdate = joptim.make_optimizer(jcfg)
    init, update = optim.make_optimizer(cfg)
    jp, p = jax.tree.map(jnp.asarray, params), _t_tree(params)
    jst, st = jinit(jp), init(p)
    for _ in range(5):
        g = _grad_tree(rng, params, scale=rng.choice([1e-3, 1.0, 30.0]))
        jp, jst = jupdate(jcfg, jax.tree.map(jnp.asarray, g), jst, jp)
        p, st = update(cfg, _t_tree(g), st, p)
    _tree_close(p, jp, OPT_RTOL, OPT_ATOL)
    _tree_close(st, jst, OPT_RTOL, OPT_ATOL)
    assert int(st["step"]) == int(jst["step"]) == 5 and st["step"].dtype == torch.int32


def test_adafactor_state_is_factored_on_the_stacked_leaves():
    p = _t_tree(_params(np.random.default_rng(0)))
    st = optim.adafactor_init(p)
    assert st["v"]["layers"]["ln"]["scale"]["v_row"].shape == (2,)   # a stacked [L, D] scale is factored
    assert st["v"]["layers"]["ln"]["scale"]["v_col"].shape == (8,)
    assert st["v"]["layers"]["w"]["v_row"].shape == (2, 8)
    assert st["v"]["layers"]["w"]["v_col"].shape == (2, 6)
    assert st["v"]["embed"]["v_row"].shape == (10,)
    assert st["v"]["bias"]["v"].shape == ()


def test_adafactor_clips_two_layers_of_a_leaf_together():
    """Two layers whose gradients differ 1000x in scale: the reference's
    update clipping takes one RMS over the stacked leaf, so the small layer's
    update is cut by the large layer's RMS; taken per layer it is not."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(2, 8, 6)).astype(np.float32)
    g = rng.normal(size=(2, 8, 6)).astype(np.float32)
    g[0] *= 1e-3
    g[0, 0, 0] = 5.0  # a spike: the preconditioned update's RMS exceeds 1
    cfg_kw = dict(name="adafactor", lr=1e-2, warmup_steps=0, decay_steps=10, weight_decay=0.0)
    jcfg, cfg = joptim.OptimizerConfig(**cfg_kw), optim.OptimizerConfig(**cfg_kw)
    want, _ = joptim.adafactor_update(jcfg, {"w": jnp.asarray(g)}, joptim.adafactor_init({"w": jnp.asarray(w)}),
                                      {"w": jnp.asarray(w)})
    got, _ = optim.adafactor_update(cfg, {"w": torch.from_numpy(g)}, optim.adafactor_init({"w": torch.from_numpy(w)}),
                                    {"w": torch.from_numpy(w)})
    _tree_close(got, want, OPT_RTOL, OPT_ATOL)
    per_layer = [optim.adafactor_update(cfg, {"w": torch.from_numpy(g[i])},
                                        optim.adafactor_init({"w": torch.from_numpy(w[i])}),
                                        {"w": torch.from_numpy(w[i])})[0]["w"] for i in range(2)]
    moved = np.abs(torch.stack(per_layer).numpy() - np.asarray(want["w"]))
    assert moved.max() > 1e-4  # the stacked clipping binds: a per-layer port computes something else


def test_ef_compression_matches_jax():
    rng = np.random.default_rng(4)
    grads = {"a": rng.normal(size=(5, 7)).astype(np.float32),
             "b": {"c": (rng.normal(size=(9,)) * 1e-3).astype(np.float32)}}
    jres, res = joptim.ef_init(jax.tree.map(jnp.asarray, grads)), optim.ef_init(_t_tree(grads))
    for step in range(3):
        g = _grad_tree(rng, grads, scale=10.0 ** -step)
        jpay, jres = joptim.ef_compress(jax.tree.map(jnp.asarray, g), jres)
        pay, res = optim.ef_compress(_t_tree(g), res)
        for key in ("a",):
            assert pay[key]["q"].dtype == torch.int8
            np.testing.assert_array_equal(pay[key]["q"].numpy(), np.asarray(jpay[key]["q"]))
        np.testing.assert_array_equal(pay["b"]["c"]["q"].numpy(), np.asarray(jpay["b"]["c"]["q"]))
        _tree_close(res, jres, OPT_RTOL, OPT_ATOL)
        _tree_close(optim.ef_decompress(pay), joptim.ef_decompress(jpay), OPT_RTOL, OPT_ATOL)
        assert optim.compressed_bytes(pay) == joptim.compressed_bytes(jpay) == 35 + 9 + 8


# ---------------- the attention's gradient ----------------

@pytest.mark.parametrize("b,s,kh,g,dh,block_kv", [
    (2, 37, 2, 2, 16, 16),   # ragged last block
    (1, 48, 1, 4, 8, 16),    # one KV head (granite), blocks divide S
    (2, 21, 3, 1, 16, 8),    # no grouping, ragged
    (1, 9, 2, 3, 16, 32),    # one block longer than S
])
def test_attention_gradient_matches_jax_grad(b, s, kh, g, dh, block_kv):
    rng = np.random.default_rng(s + kh)
    q = rng.normal(size=(b, s, kh, g, dh)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, kh, dh)).astype(np.float32) for _ in range(2))
    dout = rng.normal(size=(b, s, kh * g, dh)).astype(np.float32)

    def jloss(q, k, v):
        return (jattn.blocked_causal_attention_gqa(q, k, v, block_kv=block_kv) * dout).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attention.blocked_causal_attention_gqa(tq, tk, tv, block_kv=block_kv)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    (out * torch.from_numpy(dout)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=ATTN_GRAD_TOL, atol=ATTN_GRAD_TOL)


def test_attention_function_takes_a_given_forward_and_casts_grads():
    """``FlashAttention.apply(..., forward)`` runs the given forward (the chip
    script passes the plain version on the card); bf16 inputs get bf16
    gradients computed in float32, within a bf16 step of the float32 ones."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(1, 40, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, 40, 2, 16)).astype(np.float32)) for _ in range(2))
    calls = []

    def fwd(q, k, v):
        calls.append(q.shape)
        return flash_attention_plain(q, k, v, block_kv=16)

    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        xs = [x.detach().to(dtype).requires_grad_() for x in (q, k, v)]
        FlashAttention.apply(*xs, 16, fwd).float().square().sum().backward()
        grads[dtype] = [x.grad for x in xs]
    assert len(calls) == 2
    for g32, g16 in zip(grads[torch.float32], grads[torch.bfloat16]):
        assert g16.dtype == torch.bfloat16
        torch.testing.assert_close(g16.float(), g32, rtol=0.1, atol=0.05 * float(g32.abs().max()))


def test_inference_calls_bypass_the_autograd_function():
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(size=(1, 20, 2, 8)).astype(np.float32)).requires_grad_()
    with torch.no_grad():
        assert attention.flash_attention_gqa(q, q[:, :, :1], q[:, :, :1], block_kv=8).grad_fn is None
    assert attention.flash_attention_gqa(q.detach(), q[:, :, :1].detach(), q[:, :, :1].detach(),
                                         block_kv=8).grad_fn is None


# ---------------- forward, loss_fn and their gradients ----------------

def _pair(arch, seed=1, **over):
    """The JAX config and parameters, and the port's config and a masters
    model holding the same numbers."""
    jcfg = dataclasses.replace(jax_get_arch(arch).make_smoke_config(), **over)
    cfg = dataclasses.replace(get_arch(arch).make_smoke_config(),
                              **{k: (torch.bfloat16 if v is jnp.bfloat16 else v) for k, v in over.items()})
    params = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    model = tf.TransformerLM(cfg, seed=seed, device="cpu", masters=True)
    model.load_state_dict(tf.params_from_jax(cfg, _np_tree(params)))
    return jcfg, params, cfg, model


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, : s // 4] = -1  # masked labels
    return toks[:, :-1], labels


def test_masters_model_keeps_float32_weights_with_gradients():
    cfg = get_arch("tinyllama-1.1b").make_smoke_config()
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    model = tf.TransformerLM(cfg, seed=2, device="cpu", masters=True)
    serving = tf.TransformerLM(cfg, seed=2, device="cpu")
    assert all(p.requires_grad and p.dtype == torch.float32 for p in model.parameters())
    assert serving.layers[0].attn["wq"].dtype == torch.bfloat16
    assert torch.equal(model.layers[0].attn["wq"].to(torch.bfloat16), serving.layers[0].attn["wq"])
    tree = tf.params_tree(model)
    assert tree["layers"]["attn"]["wq"].shape == (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.dh)
    assert tree["layers"]["ln1"]["scale"].shape == (cfg.n_layers, cfg.d_model)
    serving.load_state_dict(tf.params_from_jax(cfg, tree))  # either form loads the tree
    assert torch.equal(serving.layers[1].mlp["wo"], model.layers[1].mlp["wo"].to(torch.bfloat16))


@pytest.mark.parametrize("s", [40, 16], ids=["blocked", "full"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_gradients_match_jax(arch, s):
    jcfg, params, cfg, model = _pair(arch)
    assert (s > cfg.block_kv) == (s == 40)
    tokens, labels = _batch(cfg, 2, s)
    jt, jl = jnp.asarray(tokens), jnp.asarray(labels)
    jlogits, jaux = jtf.forward(jcfg, params, jt)
    jloss, jgrads = jax.value_and_grad(lambda p: jtf.loss_fn(jcfg, p, jt, jl))(params)
    logits, aux = tf.forward(cfg, model, torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5, atol=1e-7)
    assert (float(aux.detach()) > 0) == (cfg.moe is not None)
    loss = tf.loss_fn(cfg, model, torch.from_numpy(tokens), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    grads = tf.params_tree(model, grads=True)
    _tree_close_scaled(grads, jgrads, GRAD_RTOL)


def test_bf16_gradients_stray_from_float32_no_further_than_the_reference():
    jcfg, params, cfg, model = _pair("tinyllama-1.1b", dtype=jnp.bfloat16)
    tokens, labels = _batch(cfg, 2, 40, seed=7)
    jt, jl = jnp.asarray(tokens), jnp.asarray(labels)
    jcfg32 = dataclasses.replace(jcfg, dtype=jnp.float32)
    want = jax.grad(lambda p: jtf.loss_fn(jcfg32, p, jt, jl))(params)
    ref16 = jax.grad(lambda p: jtf.loss_fn(jcfg, p, jt, jl))(params)  # op by op: no jit
    tf.loss_fn(cfg, model, torch.from_numpy(tokens), torch.from_numpy(labels)).backward()
    got = tf.params_tree(model, grads=True)
    paths = [jax.tree_util.keystr(p) for p, _ in tree_flatten_with_path(want)[0]]
    for path, g, r, w in zip(paths, tree_leaves(got), jax.tree.leaves(ref16), jax.tree.leaves(want)):
        w = np.asarray(w, np.float64)
        dp, dr = g.double().numpy() - w, np.asarray(r, np.float64) - w
        rms_p, rms_r = np.sqrt((dp**2).mean()), np.sqrt((dr**2).mean())
        assert rms_p <= NOISE_RMS_RATIO * rms_r, (path, rms_p, rms_r)
        assert np.abs(dp).max() <= NOISE_MAX_RATIO * np.abs(dr).max(), (path, np.abs(dp).max(), np.abs(dr).max())


# ---------------- the train step ----------------

@pytest.mark.parametrize("arch,name,remat", [
    ("tinyllama-1.1b", "adamw", True),
    ("tinyllama-1.1b", "adamw", False),
    ("granite-34b", "adafactor", True),
    ("grok-1-314b", "adafactor", False),
])
def test_lm_train_step_matches_jax(arch, name, remat):
    """Two microbatches, three steps. AdamW's eps is raised to 1e-4 here:
    AdamW divides each element's step by its own gradient's size, so an
    element whose gradient lies within float32 summation noise of zero
    (|g| ~ 1e-9 against the default eps of 1e-8) takes a step of either sign
    in the two packages; the formula itself is held exactly above."""
    jcfg, params, cfg, model = _pair(arch, microbatches=2, remat=remat)
    kw = dict(name=name, lr=1e-2, warmup_steps=2, decay_steps=10, eps=1e-4)
    jo, po = joptim.OptimizerConfig(**kw), optim.OptimizerConfig(**kw)
    jst, st = joptim.make_optimizer(jo)[0](params), optim.make_optimizer(po)[0](tf.params_tree(model))
    jstep, step = jax.jit(jax_lm_train_step(jcfg, jo)), lm_train_step(cfg, po)
    for i in range(3):
        tokens, labels = _batch(cfg, 4, 40, seed=10 + i)
        params, jst, jm = jstep(params, jst, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
        model, st, m = step(model, st, {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=STEP_RTOL)
        np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]), rtol=STEP_RTOL)
    assert all(p.grad is None for p in model.parameters())
    _tree_close(tf.params_tree(model), params, 0, PARAM_ATOL)
    _tree_close_scaled(st, jst, GRAD_RTOL)  # moments: sums of the gradients


def test_lm_train_step_remat_and_microbatches_change_nothing():
    """The same batch through one step with and without remat, and as one
    or two microbatches (the mean of the halves' losses, which at equal
    label counts is the whole batch's); AdamW's eps raised as above."""
    out = {}
    for remat, mb in ((False, 1), (True, 1), (True, 2)):
        _, _, cfg, model = _pair("stablelm-1.6b", remat=remat, microbatches=mb)
        po = optim.OptimizerConfig(lr=1e-3, warmup_steps=0, decay_steps=10, eps=1e-4)
        st = optim.adamw_init(tf.params_tree(model))
        tokens, labels = _batch(cfg, 2, 24, seed=3)
        labels[:] = np.abs(labels)  # equal label counts in both halves
        _, _, m = lm_train_step(cfg, po)(model, st, {"tokens": torch.from_numpy(tokens),
                                                      "labels": torch.from_numpy(labels)})
        out[(remat, mb)] = (float(m["loss"]), tf.params_tree(model))
    base_loss, base = out[(False, 1)]
    for key, (loss, tree) in out.items():
        np.testing.assert_allclose(loss, base_loss, rtol=1e-6)
        for a, b in zip(tree_leaves(tree), tree_leaves(base)):
            torch.testing.assert_close(a, b, rtol=0, atol=PARAM_ATOL)
