"""Mixture-of-Experts block (top-k routing, SwiGLU experts).

Two dispatch strategies, selectable per config, ported literally from the
reference (``repro.layers.moe``):

  * ``dense``  — GShard-style dispatch/combine einsums with an explicit
    ``[tokens, experts, capacity]`` one-hot tensor; a (token, choice) pair
    keeps its place in its expert's buffer by its rank in the token-major
    ``[T·k, E]`` cumsum, and pairs past the capacity are dropped.
  * ``gather`` — capacity-bounded gather dispatch: per expert (and token
    group), its top-C tokens by gate, gathered as ``[G, E, C, D]``; the
    combine is a scatter-add.

Dropped pairs pass through the residual only, as in the reference. Its
top-k (``lax.top_k``) puts equal values in index order and ``torch.topk``
leaves that order open, so every top-k here is a stable descending sort cut
to k: the router's choice, and the gather's top-C, whose affinities are
exactly 0 for every token that did not choose the expert. The router's
product runs in IEEE float32 even where TF32 is allowed. The reference's
``constrain`` calls (activation sharding) have no counterpart on one device.
Products are ``torch.einsum``/``matmul``, as the reference leaves them to
XLA; functions on tensors, on the device of their inputs.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.nn import functional as F

from .mlp import swiglu


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    dispatch: str = "dense"  # "dense" | "gather"
    # gather dispatch: number of token groups with *local* capacity (the
    # reference sets it to its data-shard count)
    dispatch_groups: int = 1
    # arctic-style dense residual MLP running in parallel with the experts
    dense_residual: bool = False


@contextlib.contextmanager
def _ieee_float32():
    """Float32 products in full float32 inside the block, whatever the
    caller's TF32 setting: a TF32 router flips near-tie expert choices."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the k largest, descending, equal
    values in ascending position."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def router_probs(params, x: torch.Tensor) -> torch.Tensor:
    """x: [T, D] → probs [T, E] (float32 router as is standard)."""
    with _ieee_float32():
        logits = x.float() @ params["w_router"].float()
    return torch.softmax(logits, dim=-1)


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(c, 1)


def route(params, x: torch.Tensor, cfg: MoEConfig):
    """The router's choice: (probs [T, E], gate_vals [T, k] renormalised to
    sum 1, gate_idx [T, k]), as both dispatches make it."""
    probs = router_probs(params, x)
    gate_vals, gate_idx = top_k(probs, cfg.top_k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, gate_idx


def dense_positions(gate_idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """[T, k]: each (token, choice) pair's place in its expert's capacity
    buffer, counted over the token-major flattened ``[T·k, E]`` one-hot; the
    dense dispatch keeps the pairs whose place is below the capacity."""
    t, k = gate_idx.shape
    flat = F.one_hot(gate_idx, num_experts).reshape(t * k, num_experts)
    pos = flat.cumsum(0) - flat
    return (pos * flat).sum(-1).reshape(t, k)


def _expert_ffn(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU with stacked expert weights: x [E, C, D] → [E, C, D]."""
    g = torch.einsum("ecd,edf->ecf", x, params["wi_gate"])
    u = torch.einsum("ecd,edf->ecf", x, params["wi_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    del g, u
    return torch.einsum("ecf,efd->ecd", h, params["wo"])


def moe_dense_dispatch(params, x: torch.Tensor, cfg: MoEConfig):
    """GShard dense dispatch. x: [T, D] → ([T, D], aux_loss)."""
    t, d = x.shape
    e = cfg.num_experts
    c = _capacity(t, cfg)

    probs, gate_vals, gate_idx = route(params, x, cfg)
    pos = dense_positions(gate_idx, e)                              # [T, k]
    keep = pos < c

    onehot_e = F.one_hot(gate_idx, e).to(x.dtype)                   # [T, k, E]
    # out-of-capacity positions fall outside the C classes → all-zero rows
    onehot_c = F.one_hot(torch.where(keep, pos, c), c + 1)[..., :c].to(x.dtype)  # [T, k, C]
    disp = torch.einsum("tke,tkc->tkec", onehot_e, onehot_c)        # [T, k, E, C]
    del onehot_e, onehot_c
    dispatch = disp.sum(1)                                          # [T, E, C]
    combine = torch.einsum("tk,tkec->tec", gate_vals.to(x.dtype), disp)
    del disp

    expert_in = torch.einsum("tec,td->ecd", dispatch, x)
    del dispatch
    expert_out = _expert_ffn(params, expert_in)
    out = torch.einsum("tec,ecd->td", combine, expert_out)

    aux = _aux_loss(probs, gate_idx, e)
    return out, aux


def moe_gather_dispatch(params, x: torch.Tensor, cfg: MoEConfig):
    """Capacity-bounded gather dispatch (no T×E×C tensor). x: [T, D].

    With ``dispatch_groups`` = G > 1, tokens are split into G groups, each
    with capacity C/G enforced locally (G = 1 when T is no multiple of G)."""
    t, d = x.shape
    e = cfg.num_experts
    g = max(int(cfg.dispatch_groups), 1)
    if t % g != 0:
        g = 1
    tg = t // g
    c = min(max(_capacity(t, cfg) // g, 1), tg)

    probs, gate_vals, gate_idx = route(params, x, cfg)

    # affinity[t, e] = gate weight if token t chose expert e in its top-k
    experts = torch.arange(e, device=x.device)
    gate_per_expert = (gate_vals[..., None] * (gate_idx[..., None] == experts)).sum(1)  # [T, E]
    affinity = gate_per_expert.reshape(g, tg, e).transpose(1, 2)    # [G, E, Tg]
    top_gate, tok_local = top_k(affinity, c)                        # [G, E, C]
    valid = top_gate > 0.0

    index = tok_local.reshape(g, e * c)[..., None].expand(g, e * c, d)
    gathered = torch.gather(x.reshape(g, tg, d), 1, index)          # [G, E·C, D]
    expert_in = gathered.reshape(g, e, c, d)
    expert_in = torch.where(valid[..., None], expert_in, 0)
    expert_out = _expert_ffn_grouped(params, expert_in)

    weighted = expert_out * (top_gate * valid).to(x.dtype)[..., None]
    out_g = torch.zeros((g, tg, d), dtype=x.dtype, device=x.device)
    out_g.scatter_add_(1, index, weighted.reshape(g, e * c, d))
    aux = _aux_loss(probs, gate_idx, e)
    return out_g.reshape(t, d), aux


def _expert_ffn_grouped(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU with stacked expert weights: x [G, E, C, D] → same shape."""
    h_g = torch.einsum("gecd,edf->gecf", x, params["wi_gate"])
    h_u = torch.einsum("gecd,edf->gecf", x, params["wi_up"])
    h = F.silu(h_g.float()).to(x.dtype) * h_u
    del h_g, h_u
    return torch.einsum("gecf,efd->gecd", h, params["wo"])


def _aux_loss(probs: torch.Tensor, gate_idx: torch.Tensor, e: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    f = F.one_hot(gate_idx[..., 0], e).float().mean(0)  # fraction routed (1st choice)
    p = probs.mean(0)
    return e * (f * p).sum()


def moe_block(params, x: torch.Tensor, cfg: MoEConfig):
    """x: [B, S, D] → ([B, S, D], aux). Flattens tokens for dispatch."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    fn = moe_dense_dispatch if cfg.dispatch == "dense" else moe_gather_dispatch
    out, aux = fn(params, flat, cfg)
    if cfg.dense_residual:
        out = out + swiglu(params["residual"], flat)
    return out.reshape(b, s, d), aux
