"""Shared GNN machinery: the MLP, message passing and the masked losses
(the reference's ``repro.models.gnn.common``).

Message passing is a scatter over an edge index, as in the reference
(``jax.ops.segment_sum``/``segment_max``): ``index_add`` and
``scatter_reduce`` here, outside any of the port's kernels. It is the
paper's edge-traversal workload.

Batch convention (all fixed shapes; masks encode validity):
  nodes:      [N, F] float
  src, dst:   [E] int32 (messages flow src → dst)
  edge_feat:  [E, Fe] float (optional)
  node_mask:  [N] bool
  edge_mask:  [E] bool
  graph_ids:  [N] int32 (disjoint-union batching; 0 if single graph)
  positions:  [N, 3] (SchNet)
  targets:    task-dependent

:class:`MLP` is the reference's ``mlp_init`` (its constructor) and
``mlp_apply`` (its forward) as one ``nn.Module``: linear layers with
``activation`` (ReLU unless named) between them and an optional layernorm
(eps 1e-5) after the last. The reference stores each weight ``[in, out]``
and applies it with an einsum; here it is an ``nn.Linear`` (``[out,
in]``). A GNN model's parameters follow the reference's tree: an
``nn.ModuleDict`` where it has a dict, an :class:`MLP` where it has an
``mlp_init`` tree, and an ``nn.ModuleList`` of one entry a layer where it
stacks layers on axis 0 (``jax.vmap`` of the init). :func:`params_tree`
builds the reference's tree from such a model (layers stacked again) and
:func:`state_from_tree` takes one apart into a state dict.
:func:`mlp_logical_axes` gives an MLP tree's logical axes.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ...kernels.embedding_bag.embedding_bag import bag_index


class MLP(nn.Module):
    def __init__(self, sizes: list[int], *, layernorm: bool = True, dtype=torch.float32,
                 device=None, generator: torch.Generator | None = None,
                 activation: Callable[[torch.Tensor], torch.Tensor] = F.relu):
        super().__init__()
        self.activation = activation
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device=device, dtype=dtype) for a, b in zip(sizes[:-1], sizes[1:])
        )
        # the reference's init: weights normal * fan_in**-0.5, biases zero
        with torch.no_grad():
            for layer in self.layers:
                layer.weight.normal_(generator=generator).mul_(layer.in_features ** -0.5)
                layer.bias.zero_()
        self.norm = (nn.LayerNorm(sizes[-1], eps=1e-5, device=device, dtype=dtype)
                     if layernorm else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1:
                x = self.activation(x)
        return x if self.norm is None else self.norm(x)

    def tree(self, *, grads: bool = False) -> dict:
        """The reference's ``mlp_init`` tree of this MLP (``grads``: of the
        ``.grad``s, zeros where none): each weight as ``[in, out]``."""
        def val(p: torch.Tensor) -> torch.Tensor:  # a copy: the optimizer's input outlives a load
            if not grads:
                return p.detach().clone()
            return p.grad.clone() if p.grad is not None else torch.zeros_like(p)

        out: dict = {"layers": [{"w": val(l.weight).T, "b": val(l.bias)} for l in self.layers]}
        if self.norm is not None:
            out["ln_scale"] = val(self.norm.weight)
            out["ln_bias"] = val(self.norm.bias)
        return out


def mlp_logical_axes(params: dict, prefix: tuple = ()) -> dict:
    """Logical axes for an ``mlp_init`` tree (:meth:`MLP.tree`): hidden dims
    shard over 'mlp'."""
    out: dict = {
        "layers": [
            {"w": prefix + ("gnn_in", "mlp"), "b": prefix + ("mlp",)}
            for _ in params["layers"]
        ]
    }
    if "ln_scale" in params:
        out["ln_scale"] = prefix + ("mlp",)
        out["ln_bias"] = prefix + ("mlp",)
    return out


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def mlp_state_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """State-dict entries of :class:`MLP` from the reference's ``mlp_init``
    tree (nested dicts of numpy arrays or tensors): each ``[in, out]``
    weight becomes ``layers.<i>.weight`` as ``[out, in]``."""
    out: dict[str, torch.Tensor] = {}
    for i, layer in enumerate(tree["layers"]):
        out[f"layers.{i}.weight"] = _tensor(layer["w"]).T.contiguous()
        out[f"layers.{i}.bias"] = _tensor(layer["b"])
    if "ln_scale" in tree:
        out["norm.weight"] = _tensor(tree["ln_scale"])
        out["norm.bias"] = _tensor(tree["ln_bias"])
    return out


# ---------------------------------------------------------------------------
# The reference's parameter trees
# ---------------------------------------------------------------------------

@torch.no_grad()
def params_tree(module: nn.Module, *, grads: bool = False):
    """The reference's parameter tree of a GNN model (``grads``: of its
    ``.grad``s): each ``nn.ModuleList`` stacked on axis 0 (new tensors), as
    the reference's ``jax.vmap``-initialised layers are."""
    if isinstance(module, MLP):
        return module.tree(grads=grads)
    if isinstance(module, nn.ModuleList):
        layers = [params_tree(m, grads=grads) for m in module]
        return _stack(layers)
    out = {name: params_tree(child, grads=grads) for name, child in module.named_children()}
    for name, p in module.named_parameters(recurse=False):
        out[name] = (p.grad.clone() if p.grad is not None else torch.zeros_like(p)) if grads else p.detach().clone()
    return out


def _stack(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_index(v, i) for v in tree]
    return _tensor(tree)[i]


def state_from_tree(tree: dict, stacked: str, n_layers: int) -> dict[str, torch.Tensor]:
    """The state dict of a GNN model holding the numbers of the reference's
    parameter tree (nested dicts of numpy arrays, a JAX run's, or of
    tensors, :func:`params_tree`'s), whose key ``stacked`` holds the
    ``n_layers`` layers stacked on axis 0; load it with
    ``model.load_state_dict``."""
    def flat(prefix: str, sub) -> dict[str, torch.Tensor]:
        if isinstance(sub, dict) and "layers" in sub:
            return {prefix + k: v for k, v in mlp_state_from_jax(sub).items()}
        if isinstance(sub, dict):
            return {k: v for name, s in sub.items() for k, v in flat(f"{prefix}{name}.", s).items()}
        return {prefix[:-1]: _tensor(sub)}

    state: dict[str, torch.Tensor] = {}
    for name, sub in tree.items():
        if name == stacked:
            for i in range(n_layers):
                state.update(flat(f"{name}.{i}.", _index(sub, i)))
        else:
            state.update(flat(f"{name}.", sub))
    return state


# ---------------------------------------------------------------------------
# Message passing and losses
# ---------------------------------------------------------------------------

def _segment_extreme(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int, reduce: str) -> torch.Tensor:
    """``segment_max``/``min`` into ``num_nodes`` rows (``-inf``/``+inf``
    where a row receives nothing), ids outside ``[0, num_nodes)`` dropped.
    Equal maxima share the gradient evenly, as JAX's do."""
    fill = float("-inf") if reduce == "amax" else float("inf")
    idx = bag_index(dst, num_nodes)
    idx = idx.reshape((-1,) + (1,) * (messages.dim() - 1)).expand_as(messages)
    out = messages.new_full((num_nodes + 1,) + messages.shape[1:], fill)
    return out.scatter_reduce(0, idx, messages, reduce, include_self=False)[:num_nodes]


def _segment_sum(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: ids outside ``[0, num_nodes)`` are dropped
    (sent to one extra row that is cut off; ``index_add`` would raise)."""
    out = messages.new_zeros((num_nodes + 1,) + messages.shape[1:])
    return out.index_add(0, bag_index(dst, num_nodes), messages)[:num_nodes]


def aggregate(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int, how: str = "sum") -> torch.Tensor:
    if how == "sum":
        return _segment_sum(messages, dst, num_nodes)
    if how == "mean":
        s = _segment_sum(messages, dst, num_nodes)
        n = _segment_sum(torch.ones(dst.shape, dtype=messages.dtype, device=messages.device), dst, num_nodes)
        return s / torch.clamp_min(n, 1)[:, None]
    if how in ("max", "min"):
        m = _segment_extreme(messages, dst, num_nodes, "amax" if how == "max" else "amin")
        # the reference's rule: every non-finite value (an empty row's ±inf,
        # an inf or NaN that reached the row) becomes 0
        return torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    raise ValueError(how)


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    err = ((pred - target) ** 2).mean(-1)
    return (err * mask).sum() / torch.clamp_min(mask.sum(), 1)


def masked_ce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over a float32 log-sum-exp. A label outside ``[0,
    n_classes)`` raises (the reference's ``take_along_axis`` fills NaN)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    ce = (logz - gold) * mask
    return ce.sum() / torch.clamp_min(mask.sum(), 1)
