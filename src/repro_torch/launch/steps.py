"""Cell shapes, the LM, GNN and two-tower training steps and the two-tower
serve step. The retrieval server and the configs read the shapes from
here. The reference's ``CellProgram``, ``make_lm_cell``, ``make_gnn_cell``
(with ``gnn_abstract_batch``) and ``make_recsys_cell`` wait for the
dry-run slice: :func:`recsys_train_step` and :func:`recsys_serve_step` are
the bodies of ``make_recsys_cell``'s ``train`` and ``serve`` programs."""
from __future__ import annotations

import torch

from ..models import recsys as tt
from ..models import transformer as tf
from .._tree import tree_map
from ..models.gnn.common import params_tree as gnn_params_tree
from ..optim import OptimizerConfig, clip_by_global_norm, clip_by_global_norm_, make_optimizer


def pad_to(n: int, multiple: int = 512) -> int:
    return ((n + multiple - 1) // multiple) * multiple


LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_graphs=1),
    "minibatch_lg": dict(n_nodes=169_984, n_edges=168_960, d_feat=602, n_graphs=1),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_graphs=1),
    "molecule": dict(n_nodes=3840, n_edges=8192, d_feat=16, n_graphs=128),
}

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="score", batch=1, n_candidates=1_048_576),
}


def lm_train_step(cfg: tf.LMConfig, opt_cfg: OptimizerConfig):
    """``step(model, opt_state, batch) -> (model, opt_state, metrics)``: the
    reference's train program for a ``TransformerLM`` built with
    ``masters=True``. Each of ``cfg.microbatches`` slices of the batch is
    differentiated in turn and the gradients summed in microbatch order
    (autograd's accumulation into ``.grad``), then divided by their count,
    and the loss the same way; then global-norm clipping and the optimizer
    update over the reference's tree (:func:`tf.params_tree`: stacked layer
    leaves). The model's weights are updated in place (the reference returns
    new ones); ``opt_state`` is a new tree. ``metrics`` holds ``loss`` and
    ``gnorm`` as 0-d tensors."""
    _, update = make_optimizer(opt_cfg)

    def step(model: tf.TransformerLM, opt_state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        b, s = tokens.shape
        mb = cfg.microbatches
        model.zero_grad(set_to_none=True)
        toks, labs = tokens.reshape(mb, b // mb, s), labels.reshape(mb, b // mb, s)
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(mb):  # at mb = 1 the sum and the division are exact: the reference's other branch
            part = tf.loss_fn(cfg, model, toks[i], labs[i])
            part.backward()
            loss = loss + part.detach()
        loss = loss / mb
        grads = tree_map(lambda g: g / mb, tf.params_tree(model, grads=True))
        model.zero_grad(set_to_none=True)
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm)
        params, opt_state = update(opt_cfg, grads, opt_state, tf.params_tree(model))
        model.load_state_dict(tf.params_from_jax(cfg, params))
        return model, opt_state, {"loss": loss, "gnorm": gnorm}

    return step


def gnn_train_step(model_mod, cfg, opt_cfg: OptimizerConfig, *, n_graphs: int, blocked: bool = False):
    """``step(model, opt_state, batch) -> (model, opt_state, metrics)``: the
    body of the reference's ``make_gnn_cell`` program for a GNN model of
    ``model_mod`` (``models.gnn.meshgraphnet``, ``pna``, ``schnet`` or
    ``graphcast``; ``blocked``: GraphCast's ``loss_fn_blocked``). The value
    and gradient of the loss on ``batch`` (with ``n_graphs`` set, as the
    cell's shape sets it), global-norm clipping, then the optimizer update
    over the reference's tree (``models.gnn.common.params_tree``: stacked
    layer leaves). The model's weights are updated in place; ``opt_state``
    is a new tree. ``metrics`` holds ``loss`` and ``gnorm`` as 0-d tensors."""
    _, update = make_optimizer(opt_cfg)
    loss_fn = model_mod.loss_fn_blocked if blocked else model_mod.loss_fn

    def step(model, opt_state, batch):
        model.zero_grad(set_to_none=True)
        loss = loss_fn(cfg, model, dict(batch, n_graphs=n_graphs))
        loss.backward()
        grads = gnn_params_tree(model, grads=True)
        model.zero_grad(set_to_none=True)
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm)
        params, opt_state = update(opt_cfg, grads, opt_state, gnn_params_tree(model))
        model.load_state_dict(model_mod.params_from_jax(cfg, params))
        return model, opt_state, {"loss": loss.detach(), "gnorm": gnorm}

    return step


def recsys_train_step(cfg: tt.TwoTowerConfig, opt_cfg: OptimizerConfig):
    """``step(model, opt_state, batch) -> (model, opt_state, metrics)``: the
    reference's two-tower ``train`` program (``make_recsys_cell``) for a
    ``TwoTower``. The value and gradient of ``loss_fn`` on ``batch``
    (``{"user": {field: ids}, "item": {field: ids}, "log_q": [B]}``), then
    global-norm clipping and AdamW over the reference's tree
    (:func:`tt.params_tree`), both in place: the gradients are the dense
    tensors the backward made (no second copy), and the update writes the
    parameters and ``opt_state``'s moments themselves, as the 18.54 GB of
    ``make_config()``'s tables leave no room for copies on one card.
    ``opt_state`` comes back with the new step. ``metrics`` holds ``loss``
    and ``gnorm`` as 0-d tensors."""
    _, update = make_optimizer(opt_cfg, in_place=True)

    def step(model: tt.TwoTower, opt_state, batch):
        model.zero_grad(set_to_none=True)
        loss = tt.loss_fn(cfg, model, batch)
        loss.backward()
        grads = tt.params_tree(model, grads=True)
        gnorm = clip_by_global_norm_(grads, opt_cfg.clip_norm)
        opt_state = update(opt_cfg, grads, opt_state, tt.params_tree(model))
        model.zero_grad(set_to_none=True)
        return model, opt_state, {"loss": loss.detach(), "gnorm": gnorm}

    return step


def recsys_serve_step(cfg: tt.TwoTowerConfig):
    """``step(model, user, item) -> [B]``: the reference's two-tower
    ``serve`` program, each pair's dot product ``(u * v).sum(-1)`` of the
    user and item towers' embeddings (no gradient), ``B`` the features'
    batch."""
    def step(model: tt.TwoTower, user: dict, item: dict) -> torch.Tensor:
        b = next(iter(user.values())).shape[0]
        return (model.user_embedding(user, b) * model.item_embedding(item, b)).sum(-1)

    return step
