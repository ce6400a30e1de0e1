"""Decoder-only transformer LM (llama family): GQA + RoPE + SwiGLU, with a
KV cache for prefill and decode, and the training forward and loss.

:class:`TransformerLM` holds the weights in the reference's layouts
(``wq``/``wk``/``wv`` ``[D, heads, Dh]``, ``wo`` ``[H, Dh, D]``, SwiGLU
``[D, F]``/``[F, D]``, ``embed`` ``[V, D]``, ``lm_head`` ``[D, V]``), one
:class:`Block` per layer where the reference stacks layers on axis 0
(:func:`params_tree` stacks them back; :func:`params_from_jax` takes such a
tree apart). The reference keeps float32 master weights and casts them to
``cfg.dtype`` on every call. For serving the port casts the matrices once,
when they are made or loaded, and keeps the norm scales in
``cfg.param_dtype`` (the values it computes with are identical); with
``masters=True`` (training) every weight stays in ``cfg.param_dtype`` and
carries a gradient, and :func:`forward` casts it on every call, as the
reference does (a cast to the same type is no op, so ``forward`` takes
either form).

The prefill's attention is ``layers.attention.blocked_causal_attention_gqa``:
the hand-written flash-attention kernel on the card. Training takes the
reference's choice per call (``_block``): the blocked attention, through
``kernels.attention.FlashAttention`` (the kernel's forward, a plain
PyTorch backward), where the sequence is longer than ``cfg.block_kv``, and
``repeat_kv`` + ``full_causal_attention`` otherwise; ``cfg.remat`` maps to
``torch.utils.checkpoint`` per layer. The models do not call the
reference's ``constrain`` (activation sharding; a no-op on one device) or
``scan_unroll`` (the layers are a Python loop). A layer's feed-forward
block is the SwiGLU ``mlp`` or, when ``cfg.moe`` is set (grok-1, arctic),
``layers.moe.moe_block`` over the layer's ``moe`` weights; serving
discards its auxiliary loss, as the reference does, and training adds it
to the loss.

The dry-run's helpers: :func:`init_params` (the reference's tree of a
fresh model), :func:`abstract_params` (the same tree on the ``meta``
device: shapes and dtypes, no storage), :func:`logical_axes`,
:func:`abstract_cache` and :func:`cache_logical_axes`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..graph.structure import resolve_device, seeded_generator
from ..layers.attention import attention_layer, blocked_causal_attention_gqa, decode_attention, gqa_project
from ..layers.mlp import swiglu
from ..layers.moe import MoEConfig, moe_block
from ..layers.norms import rmsnorm
from ..layers.rotary import apply_rope


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    moe: MoEConfig | None = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16      # activation/compute dtype
    param_dtype: Any = torch.float32  # master params
    block_kv: int = 1024
    remat: bool = True
    microbatches: int = 1            # gradient-accumulation splits
    seq_parallel: bool = False       # shard the prefill residual stream (no effect on one device)
    aux_loss_weight: float = 0.01

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Total parameters; for MoE also see active_param_count."""
        d, f, v, l = self.d_model, self.d_ff, self.vocab, self.n_layers
        h, k, dh = self.n_heads, self.n_kv_heads, self.dh
        attn = d * h * dh + 2 * d * k * dh + h * dh * d
        if self.moe:
            ffn = self.moe.num_experts * 3 * d * f + d * self.moe.num_experts
            if self.moe.dense_residual:
                ffn += 3 * d * f
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        return l * per_layer + 2 * v * d + d

    def active_param_count(self) -> int:
        if not self.moe:
            return self.param_count()
        d, f, v, l = self.d_model, self.d_ff, self.vocab, self.n_layers
        h, k, dh = self.n_heads, self.n_kv_heads, self.dh
        attn = d * h * dh + 2 * d * k * dh + h * dh * d
        ffn = self.moe.top_k * 3 * d * f + d * self.moe.num_experts
        if self.moe.dense_residual:
            ffn += 3 * d * f
        per_layer = attn + ffn + 2 * d
        return l * per_layer + 2 * v * d + d


class Block(nn.Module):
    """One decoder layer's weights: ``ln1``, ``attn``, ``ln2`` and ``mlp``
    or, for an MoE config, ``moe`` (``w_router [D, E]``, ``wi_gate`` and
    ``wi_up [E, D, F]``, ``wo [E, F, D]``, and with a dense residual its
    SwiGLU ``residual``), each a parameter dict as the reference's layer
    pytree."""

    def __init__(self, cfg: LMConfig, normal: Callable, ones: Callable):
        super().__init__()
        d, f, h, k, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.dh
        self.ln1 = nn.ParameterDict({"scale": ones(d)})
        self.ln2 = nn.ParameterDict({"scale": ones(d)})
        self.attn = nn.ParameterDict({
            "wq": normal(d, h, dh), "wk": normal(d, k, dh), "wv": normal(d, k, dh), "wo": normal(h, dh, d),
        })
        if cfg.moe is None:
            self.mlp = nn.ParameterDict({"wi_gate": normal(d, f), "wi_up": normal(d, f), "wo": normal(f, d)})
            return
        e = cfg.moe.num_experts
        moe = {"w_router": normal(d, e), "wi_gate": normal(e, d, f), "wi_up": normal(e, d, f),
               "wo": normal(e, f, d)}
        if cfg.moe.dense_residual:
            moe["residual"] = nn.ParameterDict(
                {"wi_gate": normal(d, f), "wi_up": normal(d, f), "wo": normal(f, d)})
        self.moe = nn.ParameterDict(moe)


class TransformerLM(nn.Module):
    """The LM's weights, initialised as the reference's ``init_params``
    (matrices normal * 0.02, norm scales 1) from a ``torch.Generator``
    seeded with ``seed`` on the model's device, which is the card unless the
    caller names another. The numbers differ from the reference's (another
    generator); :func:`params_from_jax` carries those across. By default
    the matrices are cast once to ``cfg.dtype`` and nothing carries a
    gradient (serving); ``masters=True`` keeps every weight in
    ``cfg.param_dtype`` with ``requires_grad`` (training)."""

    def __init__(self, cfg: LMConfig, *, seed: int = 0, device=None, masters: bool = False):
        super().__init__()
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        self.cfg = cfg
        matrix_dtype = cfg.param_dtype if masters else cfg.dtype

        def normal(*shape) -> nn.Parameter:  # drawn in param_dtype
            w = torch.empty(shape, dtype=cfg.param_dtype, device=dev).normal_(generator=gen).mul_(0.02)
            return nn.Parameter(w.to(matrix_dtype), requires_grad=masters)

        def ones(n) -> nn.Parameter:
            return nn.Parameter(torch.ones(n, dtype=cfg.param_dtype, device=dev), requires_grad=masters)

        self.embed = normal(cfg.vocab, cfg.d_model)
        self.lm_head = normal(cfg.d_model, cfg.vocab)
        self.layers = nn.ModuleList(Block(cfg, normal, ones) for _ in range(cfg.n_layers))
        self.final_norm = nn.ParameterDict({"scale": ones(cfg.d_model)})

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg: LMConfig, *, seed: int = 0, device=None) -> dict:
    """The reference's ``init_params`` tree (float32 masters, layers stacked
    on axis 0), drawn as :class:`TransformerLM` draws them from ``seed`` on
    ``device`` (the card unless the caller names another)."""
    return params_tree(TransformerLM(cfg, seed=seed, device=device, masters=True))


def abstract_params(cfg: LMConfig) -> dict:
    """:func:`init_params`'s tree on the ``meta`` device (no allocation) for
    the dry-run."""
    return init_params(cfg, device="meta")


def logical_axes(cfg: LMConfig) -> dict:
    """Tree (same structure as params) of logical axis-name tuples."""
    ln_l = {"scale": ("layers", "embed_nope")}
    layer: dict = {
        "ln1": dict(ln_l),
        "ln2": dict(ln_l),
        "attn": {
            "wq": ("layers", "embed", "heads", "head_dim"),
            "wk": ("layers", "embed", "kv_heads", "head_dim"),
            "wv": ("layers", "embed", "kv_heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed"),
        },
    }
    if cfg.moe:
        moe = {
            "w_router": ("layers", "embed", "experts_nope"),
            "wi_gate": ("layers", "experts", "embed", "mlp"),
            "wi_up": ("layers", "experts", "embed", "mlp"),
            "wo": ("layers", "experts", "mlp", "embed"),
        }
        if cfg.moe.dense_residual:
            moe["residual"] = {
                "wi_gate": ("layers", "embed", "mlp"),
                "wi_up": ("layers", "embed", "mlp"),
                "wo": ("layers", "mlp", "embed"),
            }
        layer["moe"] = moe
    else:
        layer["mlp"] = {
            "wi_gate": ("layers", "embed", "mlp"),
            "wi_up": ("layers", "embed", "mlp"),
            "wo": ("layers", "mlp", "embed"),
        }
    return {
        "embed": ("vocab", "embed"),
        "layers": layer,
        "final_norm": {"scale": ("embed_nope",)},
        "lm_head": ("embed", "vocab"),
    }


def params_from_jax(cfg: LMConfig, tree: dict) -> dict[str, torch.Tensor]:
    """The state dict of :class:`TransformerLM` holding the numbers of the
    reference's ``init_params(cfg, key)`` tree, given as nested dicts of
    numpy arrays (a JAX run's, or a checkpoint's) or of tensors (the
    optimizer's, :func:`params_tree`'s) with the layers stacked on axis 0
    (an MoE layer's ``moe`` group nests its ``residual``); load it with
    ``model.load_state_dict``, which copies each weight into the model's
    type (``cfg.dtype`` for a serving model's matrices, float32 masters)."""
    def t(a) -> torch.Tensor:
        return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))

    state = {
        "embed": t(tree["embed"]),
        "lm_head": t(tree["lm_head"]),
        "final_norm.scale": t(tree["final_norm"]["scale"]),
    }
    def flat(prefix: str, group: dict):
        for name, sub in group.items():
            if isinstance(sub, dict):
                yield from flat(f"{prefix}{name}.", sub)
            else:
                yield f"{prefix}{name}", sub

    for name, stacked in flat("", tree["layers"]):
        stacked = t(stacked)
        for i in range(cfg.n_layers):
            state[f"layers.{i}.{name}"] = stacked[i]
    return state


@torch.no_grad()
def params_tree(model: TransformerLM, *, grads: bool = False) -> dict:
    """The reference's parameter tree of ``model`` (``grads``: of its
    ``.grad``s): ``embed``, ``lm_head``, ``final_norm``, and ``layers``
    with each layer tensor stacked on axis 0 (new tensors, on the model's
    device). These are the leaves the optimizer and the checkpoints see."""
    def val(p: torch.Tensor) -> torch.Tensor:
        return p.grad if grads else p

    layers: dict = {}
    for name, _ in model.layers[0].named_parameters():
        *path, leaf = name.split(".")
        node = layers
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = torch.stack([val(layer.get_parameter(name)) for layer in model.layers])
    return {"embed": val(model.embed).clone(), "lm_head": val(model.lm_head).clone(),
            "final_norm": {"scale": val(model.final_norm["scale"]).clone()}, "layers": layers}


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------

def _cast(group, dtype) -> dict:
    """A layer's weight group (nested) cast to ``dtype``: a copy per call
    for float32 masters, the weights themselves when already of that type."""
    return {k: _cast(v, dtype) if isinstance(v, nn.ParameterDict) else v.to(dtype) for k, v in group.items()}


def _block(cfg: LMConfig, layer: Block, x: torch.Tensor, positions: torch.Tensor, attention=None):
    h = rmsnorm(layer.ln1, x, eps=cfg.norm_eps)
    h = attention_layer(
        _cast(layer.attn, cfg.dtype),
        h.to(cfg.dtype),
        positions,
        n_kv_heads=cfg.n_kv_heads,
        rope_theta=cfg.rope_theta,
        block_kv=cfg.block_kv,
        use_blocked=x.shape[1] > cfg.block_kv,
        attention=attention,
    )
    x = x + h
    h2 = rmsnorm(layer.ln2, x, eps=cfg.norm_eps)
    if cfg.moe:
        h2, aux = moe_block(_cast(layer.moe, cfg.dtype), h2.to(cfg.dtype), cfg.moe)
    else:
        h2 = swiglu(_cast(layer.mlp, cfg.dtype), h2.to(cfg.dtype))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h2, aux


def forward(cfg: LMConfig, model: TransformerLM, tokens: torch.Tensor, *, attention=None):
    """tokens [B, S] → logits [B, S, V] (cfg.dtype), aux loss (float32, the
    layers' MoE auxiliary losses summed). ``attention(q, k, v)`` replaces
    the blocked attention, as in :func:`prefill`; with ``cfg.remat`` each
    layer's activations are recomputed in the backward."""
    b, s = tokens.shape
    # the rows of the cast table, gathered before the cast: its gradient sums in float32
    x = model.embed[tokens.long()].to(cfg.dtype)
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in model.layers:
        if cfg.remat:
            x, a = checkpoint(_block, cfg, layer, x, positions, attention, use_reentrant=False)
        else:
            x, a = _block(cfg, layer, x, positions, attention)
        aux = aux + a
    x = rmsnorm(model.final_norm, x, eps=cfg.norm_eps)
    return x @ model.lm_head.to(cfg.dtype), aux


def loss_fn(cfg: LMConfig, model: TransformerLM, tokens: torch.Tensor, labels: torch.Tensor, *, attention=None):
    """Next-token CE (labels = tokens shifted by caller; < 0 = masked), in
    float32 over a log-sum-exp, plus ``aux_loss_weight`` times the aux loss."""
    logits, aux = forward(cfg, model, tokens, attention=attention)
    logits = logits.float()
    labels = labels.long()
    mask = labels >= 0
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    ce = (logz - gold) * mask
    loss = ce.sum() / mask.sum().clamp_min(1)
    return loss + cfg.aux_loss_weight * aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None, device=None):
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.dh)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "len": torch.zeros(batch, dtype=torch.int32, device=dev),
    }


def abstract_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None) -> dict:
    """:func:`init_cache`'s tree on the ``meta`` device."""
    return init_cache(cfg, batch, max_len, dtype, device="meta")


def cache_logical_axes() -> dict:
    return {
        "k": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
        "v": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
        "len": ("batch",),
    }


def _mlp_residual(cfg: LMConfig, layer: Block, y: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(layer.ln2, y, eps=cfg.norm_eps)
    if cfg.moe is None:
        return y + swiglu(layer.mlp, h)
    return y + moe_block(layer.moe, h, cfg.moe)[0]


def _out_proj(att: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    b, s, h, dh = att.shape
    return att.reshape(b, s, h * dh) @ wo.reshape(h * dh, -1)


@torch.no_grad()
def decode_step(cfg: LMConfig, model: TransformerLM, tokens: torch.Tensor, cache: dict, advance=None):
    """One decode step. tokens [B, 1] → (logits [B, V], cache).

    ``advance`` [B] bool: slots where False neither write KV nor advance
    their length (continuous-batching engines admit slots independently).
    The cache is updated in place and returned (the reference returns a
    new one); a slot whose length has reached ``max_len`` reads its last
    entry and writes nothing, as the reference's clamped gather and dropped
    scatter do."""
    b = tokens.shape[0]
    dev = tokens.device
    adv = torch.ones(b, dtype=torch.bool, device=dev) if advance is None else advance.to(dev)
    max_len = cache["k"].shape[2]
    pos = cache["len"].long()
    at = pos.clamp(max=max_len - 1)                        # the reference's clamped gather
    write = (adv & (pos < max_len))[:, None, None]         # its scatter past the end is dropped
    bidx = torch.arange(b, device=dev)
    x = model.embed[tokens.long()]                         # [B,1,D]
    positions = cache["len"][:, None]                      # [B,1]
    new_len = cache["len"] + adv.to(torch.int32)
    for i, layer in enumerate(model.layers):
        h = rmsnorm(layer.ln1, x, eps=cfg.norm_eps)
        q, k_new, v_new = gqa_project(layer.attn, h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
        k_c, v_c = cache["k"][i], cache["v"][i]
        # masked slots (and slots past the end) rewrite their existing entry
        k_c[bidx, at] = torch.where(write, k_new[:, 0], k_c[bidx, at]).to(k_c.dtype)
        v_c[bidx, at] = torch.where(write, v_new[:, 0], v_c[bidx, at]).to(v_c.dtype)
        att = decode_attention(q, k_c, v_c, new_len, q_per_kv=cfg.q_per_kv)
        x = _mlp_residual(cfg, layer, x + _out_proj(att, layer.attn["wo"]))
    x = rmsnorm(model.final_norm, x, eps=cfg.norm_eps)
    logits = (x @ model.lm_head)[:, 0]
    cache["len"] = new_len
    return logits, cache


@torch.no_grad()
def prefill(cfg: LMConfig, model: TransformerLM, tokens: torch.Tensor, max_len: int, *, attention=None):
    """Full-sequence prefill returning logits for the last position + cache.

    ``attention(q [B,S,H,Dh], k [B,S,K,Dh], v) -> [B,S,H,Dh]`` replaces the
    layer's causal attention (``chip_smoke.py`` passes the kernel's plain
    version to check the kernel's path against it); by default it is
    ``blocked_causal_attention_gqa``, the kernel on the card."""
    b, s = tokens.shape
    if max_len < s:
        raise ValueError(f"prefill: max_len {max_len} is shorter than the prompts ({s})")
    if attention is None:
        def attention(q, k, v):
            qg = q.reshape(b, s, cfg.n_kv_heads, cfg.q_per_kv, cfg.dh)
            return blocked_causal_attention_gqa(qg, k, v, block_kv=cfg.block_kv)

    x = model.embed[tokens.long()]
    positions = torch.arange(s, device=x.device).expand(b, s)
    shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads, cfg.dh)
    k_all = torch.zeros(shape, dtype=x.dtype, device=x.device)
    v_all = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i, layer in enumerate(model.layers):
        h = rmsnorm(layer.ln1, x, eps=cfg.norm_eps)
        q, k_new, v_new = gqa_project(layer.attn, h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
        att = attention(q, k_new, v_new)
        x = _mlp_residual(cfg, layer, x + _out_proj(att, layer.attn["wo"]))
        k_all[i, :, :s] = k_new
        v_all[i, :, :s] = v_new
    x = rmsnorm(model.final_norm, x, eps=cfg.norm_eps)
    logits = x[:, -1] @ model.lm_head
    cache = {"k": k_all, "v": v_all, "len": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    return logits, cache
