"""The port's attention, norms, RoPE and MLP layers against the JAX package
on the CPU, on the same numpy inputs: the flash kernel's plain version and
its device-dispatching entries against ``flash_attention_pallas`` (interpret
mode, as ``tests/test_kernels.py`` runs it), and every function of
``layers/attention.py``, ``norms.py``, ``rotary.py`` and ``mlp.py``."""
import importlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.kernels.attention import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.attention import flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels.attention import flash_attention_pallas  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import mlp as jmlp  # noqa: E402
from repro.layers import norms as jnorms  # noqa: E402
from repro.layers import rotary as jrot  # noqa: E402
from repro_torch.kernels.attention import (  # noqa: E402
    BLOCK_K,
    F32_BLOCK_Q,
    attention_ref,
    flash_attention,
    flash_attention_cuda,
    flash_attention_gqa,
    flash_attention_plain,
)
from repro_torch.layers import attention, mlp, norms, rotary  # noqa: E402

# the wrapper's module (the package re-exports ``flash_attention``, the entry)
flash_module = importlib.import_module("repro_torch.kernels.attention.flash_attention")

# the JAX package's flash-attention tolerance (tests/test_kernels.py): float32
# sums of the same terms in another order
FLASH_TOL = 2e-5
# float32 layers computed in the same order up to the products' blocking
LAYER_RTOL, LAYER_ATOL = 1e-5, 1e-6
# bf16 outputs of float32 math: at most one bf16 rounding step apart
# (2**-8 relative), where the float32 sums differ in their last bits
BF16_RTOL, BF16_ATOL = 2**-7, 1e-3


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, rtol=FLASH_TOL, atol=FLASH_TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=rtol, atol=atol)


# ---------------- the kernel's plain version and entries ----------------

@pytest.mark.parametrize("s,d,bq,bk", [(128, 32, 32, 32), (256, 64, 64, 32), (256, 32, 128, 64)])
def test_flash_plain_matches_pallas(s, d, bq, bk):
    rng = np.random.default_rng(s + d)
    q, k, v = (_np(rng, 2, s, d) for _ in range(3))
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=bq, block_k=bk)
    # [BH, S, D] as B = BH sequences of one head
    t = lambda x: torch.from_numpy(x)[:, :, None, :]  # noqa: E731
    got = flash_attention_plain(t(q), t(k), t(v), block_kv=bk)[:, :, 0, :]
    _close(got, want)
    _close(attention_ref(*(torch.from_numpy(x) for x in (q, k, v))), want)


def test_flash_bshd_entry_matches_jax():
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 128, 4, 32
    q, k, v = (_np(rng, b, s, h, d) for _ in range(3))
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=64, block_k=64)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), block_kv=64)
    _close(got, want)


@pytest.mark.parametrize("s", [1, 37, F32_BLOCK_Q + 1, 200])
@pytest.mark.parametrize("block_kv", [16, 64, 512])
def test_flash_plain_any_length(s, block_kv):
    """S no multiple of any tile: the plain version against the unblocked
    oracle and the reference's blocked twin, which pads."""
    rng = np.random.default_rng(s)
    q, k, v = (_np(rng, 2, s, 3, 32) for _ in range(3))
    got = flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), block_kv=block_kv)
    twin = jattn.blocked_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_kv=block_kv)
    _close(got, twin)
    fold = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(6, s, 32)  # noqa: E731
    oracle = jax_attention_ref(fold(q), fold(k), fold(v)).reshape(2, 3, s, 32).transpose(0, 2, 1, 3)
    _close(got, oracle)


@pytest.mark.parametrize("kh,g", [(1, 8), (2, 3), (4, 1)])
def test_flash_gqa_matches_jax_twin(kh, g):
    """Grouped KV heads, not expanded: query head h reads KV head h // G."""
    rng = np.random.default_rng(kh * 10 + g)
    b, s, d = 2, 70, 16
    q, k, v = _np(rng, b, s, kh * g, d), _np(rng, b, s, kh, d), _np(rng, b, s, kh, d)
    want = jattn.blocked_causal_attention_gqa(
        jnp.asarray(q).reshape(b, s, kh, g, d), jnp.asarray(k), jnp.asarray(v), block_kv=32
    )
    got = flash_attention_gqa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), block_kv=32)
    _close(got, want)
    expanded = lambda x: np.repeat(x, g, axis=2)  # noqa: E731
    same_h = flash_attention(torch.from_numpy(q), torch.from_numpy(expanded(k)),
                             torch.from_numpy(expanded(v)), block_kv=32)
    _close(same_h, want)


def test_flash_plain_bf16_matches_pallas():
    rng = np.random.default_rng(9)
    q, k, v = (_np(rng, 2, 128, 32) for _ in range(3))
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = flash_attention_pallas(*jb, block_q=64, block_k=64)
    tb = [torch.from_numpy(np.array(x.astype(jnp.float32)))[:, :, None, :].bfloat16() for x in jb]
    got = flash_attention_plain(*tb, block_kv=64)[:, :, 0, :]
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)), rtol=BF16_RTOL, atol=BF16_ATOL)


def test_flash_entry_rejects_mismatched_heads():
    x = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="shapes differ"):
        flash_attention(x, x[:, :, :2], x[:, :, :2])


def test_flash_cpu_tensors_take_the_plain_version_only():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(_np(rng, 1, 40, 4, 32)) for _ in range(3))
    before = flash_attention_cuda.launches
    got = flash_attention_gqa(q, k, v, block_kv=16)
    assert flash_attention_cuda.launches == before
    assert torch.equal(got, flash_attention_plain(q, k, v, block_kv=16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)


def test_kernel_tile_constants_match_the_source():
    """The wrapper's tile constants and head dims are the ones both kernels
    are built with: the tensor-core kernel's rows per block and keys per tile
    by head dim, and the float32 kernel's."""
    text = (Path(flash_module.__file__).parents[2] / "csrc" / "flash_attention.cu").read_text()
    assert f"constexpr int kBQ = {flash_module.BLOCK_Q};" in text
    assert f"constexpr int kF32BQ = {flash_module.F32_BLOCK_Q};" in text
    assert f"constexpr int kF32BK = {flash_module.F32_BLOCK_K};" in text
    assert set(flash_module.BLOCK_K) == set(flash_module.HEAD_DIMS)
    for dh in flash_module.HEAD_DIMS:
        assert f"case {dh}: return launch_wgmma<T, {dh}, {flash_module.BLOCK_K[dh]}>" in text
        assert f"case {dh}: return launch_f32<{dh}>" in text


# ---------------- the tensor-core kernel's numerics, emulated ----------------

# the card tests' tolerances (tests/test_torch_cuda.py): bf16 outputs of the
# same float32 math at most one bf16 rounding step apart; fp16 as the
# long-sequence test holds it
CARD_BF16_RTOL, CARD_BF16_ATOL = 1.6e-2, 1e-5
CARD_F16_TOL = 1e-3


def _split_p_flash(q, k, v, block_k, split=True):
    """The tensor-core kernel's arithmetic in float32 on the CPU: tiles of
    ``block_k`` keys, the scale applied to the float32 scores after the
    product, and P·V as P_hi·V + P_lo·V with ``P_hi = 16-bit(p)`` and
    ``P_lo = 16-bit(p - P_hi)`` in q's type (``split=False``: P_hi alone); l
    is summed from the float32 p."""
    low = q.dtype
    b, s, h, dh = q.shape
    kh = k.shape[2]
    qt = q.reshape(b, s, kh, h // kh, dh).permute(0, 2, 3, 1, 4).float()
    kt, vt = k.permute(0, 2, 1, 3).float(), v.permute(0, 2, 1, 3).float()
    pos = torch.arange(s)
    m = torch.full(qt.shape[:-1], -1e30)
    l = torch.zeros(qt.shape[:-1])
    acc = torch.zeros(qt.shape)
    for c0 in range(0, s, block_k):
        c1 = min(c0 + block_k, s)
        scores = torch.einsum("bkgsd,bktd->bkgst", qt, kt[:, :, c0:c1]) * dh**-0.5
        scores = scores.masked_fill(torch.arange(c0, c1)[None, :] > pos[:, None], -1e30)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        p_hi = p.to(low).float()
        pv = torch.einsum("bkgst,bktd->bkgsd", p_hi, vt[:, :, c0:c1])
        if split:
            p_lo = (p - p_hi).to(low).float()
            pv = pv + torch.einsum("bkgst,bktd->bkgsd", p_lo, vt[:, :, c0:c1])
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh).to(low)


def _qkv16(seed, s, h, kh, dh, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(_np(rng, 2, s, n, dh)).to(dtype) for n in (h, kh, kh)]


def _card_close(got, want):
    if got.dtype == torch.bfloat16:
        torch.testing.assert_close(got, want, rtol=CARD_BF16_RTOL, atol=CARD_BF16_ATOL)
    else:
        torch.testing.assert_close(got, want, rtol=CARD_F16_TOL, atol=CARD_F16_TOL)


@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("s", [129, 600])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_split_p_numerics_meet_the_card_tolerance(dh, g, s, dtype):
    """Split-P with l from float32 p, at the kernel's own tile width, holds
    the plain version at the card tests' unchanged tolerances."""
    q, k, v = _qkv16(s + dh + g, s, 2 * g, 2, dh, getattr(torch, dtype))
    want = flash_attention_plain(q, k, v, block_kv=64)
    _card_close(_split_p_flash(q, k, v, BLOCK_K[dh]), want)


def test_unsplit_p_misses_the_bf16_tolerance():
    """Why the kernel splits P: P rounded to bf16 alone moves outputs past a
    bf16 step of the float32 reference."""
    q, k, v = _qkv16(600 + 64 + 8, 600, 16, 2, 64, torch.bfloat16)
    want = flash_attention_plain(q, k, v, block_kv=64).float()
    got = _split_p_flash(q, k, v, BLOCK_K[64], split=False).float()
    outside = (got - want).abs() > CARD_BF16_ATOL + CARD_BF16_RTOL * want.abs()
    assert outside.float().mean() > 0.01


# ---------------- layers/attention.py ----------------

def _attn_params(rng, d, h, kh, dh):
    return {"wq": _np(rng, d, h, dh, scale=0.1), "wk": _np(rng, d, kh, dh, scale=0.1),
            "wv": _np(rng, d, kh, dh, scale=0.1), "wo": _np(rng, h, dh, d, scale=0.1)}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def test_gqa_project_and_repeat_kv_match_jax():
    rng = np.random.default_rng(2)
    p, x = _attn_params(rng, 24, 6, 2, 8), _np(rng, 2, 5, 24)
    got, want = attention.gqa_project(_t(p), torch.from_numpy(x)), jattn.gqa_project(_j(p), jnp.asarray(x))
    for a, b in zip(got, want):
        assert a.is_contiguous()
        _close(a, b, LAYER_RTOL, LAYER_ATOL)
    k = _np(rng, 2, 5, 2, 8)
    for groups in (1, 3):
        assert np.array_equal(attention.repeat_kv(torch.from_numpy(k), groups).numpy(),
                              np.asarray(jattn.repeat_kv(jnp.asarray(k), groups)))


@pytest.mark.parametrize("s,block_kv", [(33, 16), (64, 64)])
def test_blocked_and_full_attention_match_jax(s, block_kv):
    rng = np.random.default_rng(s)
    q, k, v = (_np(rng, 2, s, 4, 16) for _ in range(3))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    _close(attention.blocked_causal_attention(tq, tk, tv, block_kv=block_kv),
           jattn.blocked_causal_attention(jq, jk, jv, block_kv=block_kv))
    _close(attention.full_causal_attention(tq, tk, tv), jattn.full_causal_attention(jq, jk, jv))
    q5 = q.reshape(2, s, 2, 2, 16)
    _close(attention.blocked_causal_attention_gqa(torch.from_numpy(q5), tk[:, :, :2], tv[:, :, :2],
                                                  block_kv=block_kv),
           jattn.blocked_causal_attention_gqa(jnp.asarray(q5), jk[:, :, :2], jv[:, :, :2], block_kv=block_kv))


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(4)
    b, s, kh, g, dh = 3, 12, 2, 3, 8
    q, kc, vc = _np(rng, b, 1, kh * g, dh), _np(rng, b, s, kh, dh), _np(rng, b, s, kh, dh)
    lens = np.array([1, 7, 12], np.int32)
    got = attention.decode_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                                     torch.from_numpy(lens), q_per_kv=g)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens), q_per_kv=g)
    _close(got, want, LAYER_RTOL, LAYER_ATOL)


@pytest.mark.parametrize("use_blocked,grouped_gqa", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("kh", [1, 2, 4])
def test_attention_layer_matches_jax(use_blocked, grouped_gqa, kh):
    rng = np.random.default_rng(kh)
    b, s, d, h, dh = 2, 21, 32, 4, 8
    p, x = _attn_params(rng, d, h, kh, dh), _np(rng, b, s, d)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    kw = dict(n_kv_heads=kh, rope_theta=500.0, block_kv=8, use_blocked=use_blocked, grouped_gqa=grouped_gqa)
    got = attention.attention_layer(_t(p), torch.from_numpy(x), torch.from_numpy(pos), **kw)
    want = jattn.attention_layer(_j(p), jnp.asarray(x), jnp.asarray(pos), **kw)
    _close(got, want, LAYER_RTOL, LAYER_ATOL)


# ---------------- norms, RoPE, MLP ----------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(dtype):
    rng = np.random.default_rng(6)
    x = _np(rng, 3, 5, 40, scale=3.0) + 0.5
    scale, bias = _np(rng, 40), _np(rng, 40)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    tol = (LAYER_RTOL, LAYER_ATOL) if dtype == "float32" else (BF16_RTOL, BF16_ATOL)
    got = norms.rmsnorm({"scale": torch.from_numpy(scale)}, tx, eps=1e-5)
    want = jnorms.rmsnorm({"scale": jnp.asarray(scale)}, jx, eps=1e-5)
    assert got.dtype == tx.dtype
    _close(got, np.asarray(want.astype(jnp.float32)), *tol)
    got = norms.layernorm({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}, tx)
    want = jnorms.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jx)
    _close(got, np.asarray(want.astype(jnp.float32)), *tol)
    assert torch.equal(norms.rmsnorm_init(7)["scale"], torch.ones(7))
    ln = norms.layernorm_init(7, dtype=torch.bfloat16)
    assert ln["scale"].dtype == torch.bfloat16 and not ln["bias"].any()


@pytest.mark.parametrize("head_dim,theta", [(16, 10000.0), (64, 10000.0), (128, 500000.0)])
def test_rope_matches_jax(head_dim, theta):
    rng = np.random.default_rng(head_dim)
    freqs = rotary.rope_frequencies(head_dim, theta)
    np.testing.assert_allclose(freqs.numpy(), np.asarray(jrot.rope_frequencies(head_dim, theta)), rtol=1e-6)
    x = _np(rng, 2, 9, 3, head_dim)
    pos = np.stack([np.arange(9), np.arange(2040, 2049)]).astype(np.int32)  # positions up to the served 2048
    got = rotary.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jrot.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    # angles of ~2e3 radians: float32 rounding of the angle itself is ~1e-4
    _close(got, want, 1e-4, 1e-4)
    # the half-split form: position 0 is the identity, and a rotation keeps each pair's norm
    zero = rotary.apply_rope(torch.from_numpy(x[:1, :1]), torch.zeros(1, 1, dtype=torch.int32), theta)
    assert torch.equal(zero, torch.from_numpy(x[:1, :1]))
    h = head_dim // 2
    pair = lambda a: a[..., :h] ** 2 + a[..., h:] ** 2  # noqa: E731
    np.testing.assert_allclose(pair(got.numpy()), pair(x), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlps_match_jax(dtype):
    rng = np.random.default_rng(8)
    x = _np(rng, 2, 3, 16)
    sw = {"wi_gate": _np(rng, 16, 24, scale=0.3), "wi_up": _np(rng, 16, 24, scale=0.3), "wo": _np(rng, 24, 16, scale=0.3)}
    ge = {"wi": _np(rng, 16, 24, scale=0.3), "wo": _np(rng, 24, 16, scale=0.3)}
    two = {"wi": _np(rng, 16, 24), "bi": _np(rng, 24), "wo": _np(rng, 24, 5), "bo": _np(rng, 5)}
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    cast_j = lambda tree: {k: jnp.asarray(v, jd) for k, v in tree.items()}  # noqa: E731
    cast_t = lambda tree: {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(td)  # noqa: E731
                           for k, v in cast_j(tree).items()}
    jx = jnp.asarray(x, jd)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(td)
    # bf16: products rounded to bf16 at each of three steps
    tol = (LAYER_RTOL, LAYER_ATOL) if dtype == "float32" else (2**-6, 2e-3)
    for got, want in (
        (mlp.swiglu(cast_t(sw), tx), jmlp.swiglu(cast_j(sw), jx)),
        (mlp.gelu_mlp(cast_t(ge), tx), jmlp.gelu_mlp(cast_j(ge), jx)),
    ):
        assert got.dtype == td
        _close(got, np.asarray(want.astype(jnp.float32)), *tol)
    _close(mlp.mlp_2layer(_t(two), torch.from_numpy(x)), jmlp.mlp_2layer(_j(two), jnp.asarray(x)),
           LAYER_RTOL, LAYER_ATOL)
    _close(mlp.mlp_2layer(_t(two), torch.from_numpy(x), activation=torch.tanh),
           jmlp.mlp_2layer(_j(two), jnp.asarray(x), activation=jax.nn.tanh), LAYER_RTOL, LAYER_ATOL)
