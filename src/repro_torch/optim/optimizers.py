"""Optimizers: AdamW and Adafactor (factored second moment), plus
global-norm clipping and the LR schedule, as plain functions over nested
dicts of tensors (the reference's pytrees).

The leaves are the reference's: an LM's layer tensors stacked on axis 0
(``models.transformer.params_tree``). That matters for Adafactor, whose
factoring test (``ndim >= 2``) and update-RMS clipping act on whole leaves:
a stacked ``[L, D]`` norm scale is factored, and one RMS clips all L
layers of a leaf together. ``torch.optim.AdamW`` is not used: it applies
the decoupled weight decay in another order. ``opt_state_logical_axes``
gives the state's logical axes for the dry-run's sharding plan.

``clip_by_global_norm_`` and ``adamw_update_`` are in-place forms for
trees too large to copy (the two-tower model's 18.54 GB of tables: a
functional update holds new parameters and moments beside the old ones).
They write the gradients, parameters and moments they are given, leaf by
leaf and, on leaves of more than ``CHUNK_ROWS`` rows, a chunk of rows at a
time, with the functional forms' expressions in the same order: the same
bits, whatever the chunks (only the norm's sum is taken in another order).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .._tree import tree_leaves, tree_map, tree_unzip
from ..graph.structure import resolve_device


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"          # "adamw" | "adafactor"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = ((step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.clamp_max(warm, 1.0) * torch.where(
        step < cfg.warmup_steps, warm / torch.clamp_min(warm, 1e-9), decay)


# rows a chunk of the in-place forms: 64 MiB of a 256-wide float32 table,
# so each temporary of the update's expressions costs at most that much
CHUNK_ROWS = 2**16


def _row_chunks(tensors: tuple, rows: int):
    """The tensors (of one shape) cut together into chunks of ``rows`` rows
    (views); one chunk of the whole tensors where they have no more rows."""
    t = tensors[0]
    if t.dim() == 0 or t.shape[0] <= rows:
        yield tensors
        return
    for r0 in range(0, t.shape[0], rows):
        yield tuple(x[r0 : r0 + rows] for x in tensors)


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-9), 1.0)


def clip_by_global_norm(grads, max_norm: float):
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float, *, chunk_rows: int = CHUNK_ROWS) -> torch.Tensor:
    """:func:`clip_by_global_norm` in place: scales the gradient tensors
    themselves and returns the norm. The squares are summed a chunk at a
    time (no temporary of a whole leaf), so the norm may differ from the
    functional one's within float32 rounding; the scaled gradients are
    ``g * scale`` bit for bit."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(c.float() ** 2) for g in leaves for (c,) in _row_chunks((g,), chunk_rows)))
    scale = _clip_scale(gnorm, max_norm)
    for g in leaves:
        g.mul_(scale.to(g.dtype))
    return gnorm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    step_dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_dev)}


def _adamw_terms(cfg: OptimizerConfig, step: torch.Tensor):
    """The step's learning rate and bias corrections (0-d tensors)."""
    return lr_schedule(cfg, step), 1 - cfg.b1 ** step.float(), 1 - cfg.b2 ** step.float()


def _adamw_leaf(cfg: OptimizerConfig, lr, bc1, bc2, g, mu, nu, p):
    """One leaf's (or chunk's) new parameters and moments."""
    b1, b2 = cfg.b1, cfg.b2
    g32 = g.float()
    mu = b1 * mu + (1 - b1) * g32
    nu = b2 * nu + (1 - b2) * g32 * g32
    delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps) + cfg.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), mu, nu


def adamw_update(cfg: OptimizerConfig, grads, state, params):
    step = state["step"] + 1
    terms = _adamw_terms(cfg, step)

    def upd(g, mu, nu, p):
        return _adamw_leaf(cfg, *terms, g, mu, nu, p)

    new_params, new_mu, new_nu = tree_unzip(tree_map(upd, grads, state["mu"], state["nu"], params), 3)
    return new_params, {"mu": new_mu, "nu": new_nu, "step": step}


@torch.no_grad()
def adamw_update_(cfg: OptimizerConfig, grads, state, params, *, chunk_rows: int = CHUNK_ROWS):
    """:func:`adamw_update` in place: writes the new parameters into the
    ``params`` tensors (views of a model's parameters update the model)
    and the new moments into ``state``'s, a chunk of rows at a time, and
    returns ``{"mu", "nu", "step"}`` with those moments and the new step.
    The same bits as the functional form."""
    step = state["step"] + 1
    terms = _adamw_terms(cfg, step)

    def upd(g, mu, nu, p):
        for gc, mc, nc, pc in _row_chunks((g, mu, nu, p), chunk_rows):
            new_p, new_mu, new_nu = _adamw_leaf(cfg, *terms, gc, mc, nc, pc)
            pc.copy_(new_p)
            mc.copy_(new_mu)
            nc.copy_(new_nu)

    tree_map(upd, grads, state["mu"], state["nu"], params)
    return {"mu": state["mu"], "nu": state["nu"], "step": step}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment for params with ndim >= 2)
# ---------------------------------------------------------------------------

def _factored(p) -> bool:
    return p.ndim >= 2


def adafactor_init(params):
    def init(p):
        if _factored(p):
            return {"v_row": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "v_col": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32, device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    step_dev = tree_leaves(params)[0].device
    return {"v": tree_map(init, params), "step": torch.zeros((), dtype=torch.int32, device=step_dev)}


def adafactor_update(cfg: OptimizerConfig, grads, state, params):
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    decay = 1.0 - (step.float() + 1.0) ** -0.8  # t^-0.8 schedule
    eps = 1e-30

    def upd(g, v, p):
        g32 = g.float()
        g2 = g32 * g32 + eps
        if _factored(p):
            v_row = decay * v["v_row"] + (1 - decay) * g2.mean(dim=-1)
            v_col = decay * v["v_col"] + (1 - decay) * g2.mean(dim=-2)
            row_mean = v_row.mean(dim=-1, keepdim=True)
            precond = (v_row / torch.clamp_min(row_mean, eps))[..., None] * v_col[..., None, :]
            update = g32 * torch.rsqrt(torch.clamp_min(precond, eps))
            new_v = {"v_row": v_row, "v_col": v_col}
        else:
            v_new = decay * v["v"] + (1 - decay) * g2
            update = g32 * torch.rsqrt(torch.clamp_min(v_new, eps))
            new_v = {"v": v_new}
        # relative update clipping (RMS <= 1), over the whole (stacked) leaf
        rms = torch.sqrt(torch.mean(update * update) + eps)
        update = update / torch.clamp_min(rms, 1.0)
        new_p = p.float() - lr * (update + cfg.weight_decay * p.float())
        return new_p.to(p.dtype), new_v

    new_params, new_v = tree_unzip(tree_map(upd, grads, state["v"], params), 2)
    return new_params, {"v": new_v, "step": step}


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------

def make_optimizer(cfg: OptimizerConfig, *, in_place: bool = False):
    """``(init, update)`` of ``cfg.name``; ``in_place``: the update that
    writes parameters and moments in place (:func:`adamw_update_`; AdamW
    only, as the two-tower cell trains with it)."""
    if in_place:
        if cfg.name != "adamw":
            raise ValueError(f"no in-place update for {cfg.name!r}: AdamW only")
        return adamw_init, adamw_update_
    if cfg.name == "adamw":
        return adamw_init, adamw_update
    if cfg.name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(cfg.name)


def opt_state_from_jax(tree, device=None):
    """An optimizer state given as numpy arrays (a JAX run's, or a
    checkpoint's: the reference's tree, layers stacked) as tensors on
    ``device`` (the card unless the caller names another)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)


def opt_state_logical_axes(cfg: OptimizerConfig, params_axes):
    """Logical axes for the optimizer state, derived from the param axes
    (a tree with a tuple of names at each leaf)."""
    if cfg.name == "adamw":
        return {
            "mu": params_axes,
            "nu": params_axes,
            "step": (),
        }

    def factored_axes(ax):
        ax = tuple(ax)
        if len(ax) >= 2:
            return {"v_row": ax[:-1], "v_col": ax[:-2] + ax[-1:]}
        return {"v": ax}

    return {"v": tree_map(factored_axes, params_axes), "step": ()}
