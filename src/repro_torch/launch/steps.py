"""Cell shapes and the LM training step. The retrieval server and the LM
configs read the shapes from here. The reference's ``CellProgram``,
``make_lm_cell`` and the GNN and recsys cell programs wait for the
dry-run slice."""
from __future__ import annotations

import torch

from ..models import transformer as tf
from .._tree import tree_map
from ..optim import OptimizerConfig, clip_by_global_norm, make_optimizer

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
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
