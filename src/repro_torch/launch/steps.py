"""Cell programs: (arch × shape) → a step function + abstract args +
sharding plans (the reference's ``repro.launch.steps``). This is what the
dry-run lowers, and the steps are what the launchers and ``chip_smoke.py``
run for real.

A :class:`CellProgram`'s ``step_fn`` is one of the port's steps
(:func:`lm_train_step`, :func:`gnn_train_step`, :func:`recsys_train_step`,
:func:`recsys_serve_step`, ``models.transformer.prefill`` and
``decode_step``, ``TwoTower.score_candidates``); its ``abstract_args`` are
tensors on the ``meta`` device, a model argument a model built there,
whose parameter tree (``param_tree``) has the reference's leaves.
:meth:`CellProgram.lower` is the one-device counterpart of
``jax.jit(...).lower``: it runs the step on the meta arguments, counting
FLOPs with ``torch.utils.flop_counter``'s formulas, and gives the outputs'
shapes and the FLOP count.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..models import recsys as tt
from ..models import transformer as tf
from .._tree import tree_map
from ..models.gnn.common import params_tree as gnn_params_tree
from ..optim import (
    OptimizerConfig,
    clip_by_global_norm,
    clip_by_global_norm_,
    make_optimizer,
    opt_state_logical_axes,
)
from ..sharding.rules import default_rules, sharding_tree

META = torch.device("meta")


def pad_to(n: int, multiple: int = 512) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _sig(x):
    """An op argument's signature for :class:`_MetaTrace`'s cache: a meta
    tensor's shape, strides and type; a tensor off ``meta`` gives an
    unhashable one, so its op is not cached."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype) if x.device.type == "meta" else [x]
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    return x


class _MetaTrace(TorchDispatchMode):
    """The meta trace: counts FLOPs and caches shapes.

    ``flops`` sums ``torch.utils.flop_counter``'s formulas (the
    ``flop_registry`` that ``FlopCounterMode`` applies: mm, bmm, addmm,
    baddbmm, convolutions, attention, and their backwards) over every op
    dispatched, as ``FlopCounterMode`` does (a CPU test holds the two
    equal), in this one mode rather than under a second Python mode that
    every op would pass through.

    A meta kernel computes its output's shape, strides and type from those
    of its inputs and its other arguments, but many run as Python
    references, and a full-depth step calls the same few thousand ops
    again for every layer and microbatch. For an op that makes
    new tensors (no mutation, no aliased output, no random or
    data-dependent shape), the first call's outputs are kept by argument
    signature and later calls get new empty tensors like them."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.outputs: dict = {}
        self.pure: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        return out

    def _is_pure(self, func) -> bool:
        pure = self.pure.get(func)
        if pure is None:
            schema = func._schema
            pure = (not schema.is_mutable and len(schema.returns) > 0
                    and all(r.alias_info is None and str(r.type) == "Tensor" for r in schema.returns)
                    and not {torch.Tag.nondeterministic_seeded, torch.Tag.dynamic_output_shape,
                             torch.Tag.data_dependent_output} & set(func.tags))
            self.pure[func] = pure
        return pure

    def _run(self, func, args, kwargs):
        if not self._is_pure(func):
            return func(*args, **kwargs)
        key = (func, _sig(args), _sig(tuple(sorted(kwargs.items()))))
        try:
            known = self.outputs.get(key)
        except TypeError:  # an unhashable argument
            return func(*args, **kwargs)
        if known is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            if all(isinstance(o, torch.Tensor) and o.device.type == "meta" for o in outs):
                self.outputs[key] = (isinstance(out, tuple), [(tuple(o.shape), o.stride(), o.dtype) for o in outs])
            return out
        many, specs = known
        outs = tuple(torch.empty_strided(shape, stride, dtype=dtype, device=META) for shape, stride, dtype in specs)
        return outs if many else outs[0]


@dataclasses.dataclass
class Lowered:
    """What :meth:`CellProgram.lower` gives: the step's outputs as trees of
    meta tensors (a model output as its parameter tree) and the FLOPs of
    ``torch.utils.flop_counter``'s formulas over the whole program (the
    matmul-family ops it dispatched, no elementwise op; the flash and
    scoring kernels' meta branches run their plain versions, so their
    products count as those of the plain backward do; see
    :class:`_MetaTrace`)."""

    out: Any
    flops: int


@dataclasses.dataclass
class CellProgram:
    """Everything needed to lower one (arch × shape) cell."""

    name: str
    kind: str                      # train | prefill | decode | serve | score
    step_fn: Callable
    abstract_args: tuple
    axes_trees: tuple              # logical axes per argument
    donate_argnums: tuple = ()
    meta: dict = dataclasses.field(default_factory=dict)
    param_tree: Callable | None = None   # model -> the reference's parameter tree

    def _tree(self, a):
        return self.param_tree(a) if isinstance(a, nn.Module) else a

    def trees(self) -> tuple:
        """The abstract arguments as trees of meta tensors, a model as its
        parameter tree: the reference's ``abstract_args``."""
        return tuple(self._tree(a) for a in self.abstract_args)

    def shardings(self, mesh, rules=None) -> tuple:
        rules = rules or default_rules(mesh)
        return tuple(
            sharding_tree(a, ax, mesh, rules)
            for a, ax in zip(self.trees(), self.axes_trees)
        )

    def lower(self, mesh, rules=None) -> Lowered:
        from ..sharding.context import activation_sharding

        rules = rules or default_rules(mesh)
        self.shardings(mesh, rules)
        # fresh dicts around the same leaves: a step that updates a dict in
        # place (decode's cache) leaves the cell's arguments as they were
        args = tuple(a if isinstance(a, nn.Module) else tree_map(lambda t: t, a) for a in self.abstract_args)
        with activation_sharding(mesh, rules), _MetaTrace() as trace:
            out = self.step_fn(*args)
        out = tuple(self._tree(o) for o in out) if isinstance(out, tuple) else self._tree(out)
        return Lowered(out=out, flops=trace.flops)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_graphs=1),
    "minibatch_lg": dict(n_nodes=169_984, n_edges=168_960, d_feat=602, n_graphs=1),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_graphs=1),
    "molecule": dict(n_nodes=3840, n_edges=8192, d_feat=16, n_graphs=128),
}

# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Cell builders
# ---------------------------------------------------------------------------

def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def served_model(cfg: tf.LMConfig, model: tf.TransformerLM) -> tf.TransformerLM:
    """A masters model (float32 weights) in the form serving holds
    (``TransformerLM(masters=False)``): a copy with the matrices in
    ``cfg.dtype`` and the norms' scales as they are, which is what the
    reference's prefill and decode read from its float32 tree. The LM
    cells' serving steps take the masters model, as the reference's take
    its tree; on ``meta`` the copy and the casts cost nothing."""
    served = copy.deepcopy(model).requires_grad_(False)
    return served._apply(lambda t: t.to(cfg.dtype) if t.ndim > 1 else t)


def make_lm_cell(cfg: tf.LMConfig, shape_name: str, opt_cfg: OptimizerConfig) -> CellProgram:
    sh = LM_SHAPES[shape_name]
    b, s = sh["batch"], sh["seq"]
    model = tf.TransformerLM(cfg, device=META, masters=True)
    p_axes = tf.logical_axes(cfg)
    common = dict(name=f"{cfg.name}:{shape_name}", param_tree=tf.params_tree)

    if sh["kind"] == "train":
        init_opt, _ = make_optimizer(opt_cfg)
        opt_abs = init_opt(tf.params_tree(model))
        o_axes = opt_state_logical_axes(opt_cfg, p_axes)
        batch_abs = {"tokens": _meta((b, s), torch.int32), "labels": _meta((b, s), torch.int32)}
        b_axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        return CellProgram(
            kind="train",
            step_fn=lm_train_step(cfg, opt_cfg),
            abstract_args=(model, opt_abs, batch_abs),
            axes_trees=(p_axes, o_axes, b_axes),
            donate_argnums=(0, 1),
            meta=dict(
                tokens=b * s,
                params=cfg.param_count(),
                active_params=cfg.active_param_count(),
                model_flops=6.0 * cfg.active_param_count() * b * s,
            ),
            **common,
        )

    if sh["kind"] == "prefill":
        def step(model, tokens):
            return tf.prefill(cfg, served_model(cfg, model), tokens, max_len=s)

        return CellProgram(
            kind="prefill",
            step_fn=step,
            abstract_args=(model, _meta((b, s), torch.int32)),
            axes_trees=(p_axes, ("batch", "seq")),
            meta=dict(
                tokens=b * s,
                params=cfg.param_count(),
                active_params=cfg.active_param_count(),
                model_flops=2.0 * cfg.active_param_count() * b * s,
            ),
            **common,
        )

    # decode: one token against a seq-length cache
    def step(model, tokens, cache):
        return tf.decode_step(cfg, served_model(cfg, model), tokens, cache)

    rules_override = {"cache_seq": ("model",)} if b > 1 else {
        "cache_seq": ("data", "model")
    }
    return CellProgram(
        kind="decode",
        step_fn=step,
        abstract_args=(model, _meta((b, 1), torch.int32), tf.abstract_cache(cfg, b, s)),
        axes_trees=(p_axes, ("batch", "seq"), tf.cache_logical_axes()),
        donate_argnums=(2,),
        meta=dict(
            tokens=b,
            params=cfg.param_count(),
            active_params=cfg.active_param_count(),
            model_flops=2.0 * cfg.active_param_count() * b,
            kv_bytes=2 * cfg.n_layers * b * s * cfg.n_kv_heads * cfg.dh * 2,
            rules_override=rules_override,
        ),
        **common,
    )


def generic_param_axes(params) -> Any:
    """GNN/recsys fallback: shard the last dim of every weight over 'mlp'."""
    def one(p):
        if p.ndim == 0:
            return ()
        return tuple([None] * (p.ndim - 1) + ["mlp"])

    return tree_map(one, params)


def gnn_abstract_batch(shape: dict, *, d_edge: int, d_target: int, with_positions: bool, per_graph_target: bool):
    n = pad_to(shape["n_nodes"])
    e = pad_to(shape["n_edges"])
    g = shape["n_graphs"]
    batch = {
        "nodes": _meta((n, shape["d_feat"]), torch.float32),
        "src": _meta((e,), torch.int32),
        "dst": _meta((e,), torch.int32),
        "edge_feat": _meta((e, d_edge), torch.float32),
        "node_mask": _meta((n,), torch.bool),
        "edge_mask": _meta((e,), torch.bool),
        "graph_ids": _meta((n,), torch.int32),
        "targets": _meta((g,) if per_graph_target else (n, d_target), torch.float32),
    }
    axes = {
        "nodes": ("nodes", None),
        "src": ("edges",),
        "dst": ("edges",),
        "edge_feat": ("edges", None),
        "node_mask": ("nodes",),
        "edge_mask": ("edges",),
        "graph_ids": ("nodes",),
        "targets": (None,) if per_graph_target else ("nodes", None),
    }
    if with_positions:
        batch["positions"] = _meta((n, 3), torch.float32)
        axes["positions"] = ("nodes", None)
    return batch, axes


def make_gnn_cell(
    arch: str,
    model_mod,
    cfg,
    shape_name: str,
    opt_cfg: OptimizerConfig,
    *,
    d_edge: int,
    d_target: int,
    with_positions: bool = False,
    per_graph_target: bool = False,
    int_targets: bool = False,
    blocked: bool = False,
    n_edge_blocks: int = 512,
) -> CellProgram:
    shape = GNN_SHAPES[shape_name]
    model = model_mod.MODEL(cfg, device=META)
    params_abs = gnn_params_tree(model)
    p_axes = generic_param_axes(params_abs)
    batch_abs, b_axes = gnn_abstract_batch(
        shape,
        d_edge=d_edge,
        d_target=d_target,
        with_positions=with_positions,
        per_graph_target=per_graph_target,
    )
    if int_targets:
        batch_abs["targets"] = _meta(batch_abs["targets"].shape[:1], torch.int32)
        b_axes["targets"] = ("nodes",)
    if blocked:
        # owner-blocked edge layout (degree-binned packaging keeps blocks
        # near-uniform; see graph.partition): src [P, Epb] global ids,
        # dst_local [P, Epb] within the owner's node range
        p_blk = n_edge_blocks
        epb = pad_to((pad_to(shape["n_edges"]) + p_blk - 1) // p_blk, 128)
        for k in ("src", "dst", "edge_feat", "edge_mask"):
            batch_abs.pop(k)
            b_axes.pop(k)
        batch_abs["src"] = _meta((p_blk, epb), torch.int32)
        batch_abs["dst_local"] = _meta((p_blk, epb), torch.int32)
        batch_abs["edge_feat"] = _meta((p_blk, epb, d_edge), torch.float32)
        batch_abs["edge_mask"] = _meta((p_blk, epb), torch.bool)
        b_axes["src"] = ("edge_blocks", None)
        b_axes["dst_local"] = ("edge_blocks", None)
        b_axes["edge_feat"] = ("edge_blocks", None, None)
        b_axes["edge_mask"] = ("edge_blocks", None)

    init_opt, _ = make_optimizer(opt_cfg)
    opt_abs = init_opt(params_abs)
    o_axes = opt_state_logical_axes(opt_cfg, p_axes)

    d_hidden = getattr(cfg, "d_hidden", 128)
    n_layers = getattr(cfg, "n_layers", getattr(cfg, "n_interactions", 1))
    # per message-passing layer: edge MLP + node MLP ≈ 6·E·d² + 4·N·d² MACs
    model_flops = 6.0 * (
        shape["n_edges"] * 6 * d_hidden**2 + shape["n_nodes"] * 4 * d_hidden**2
    ) * n_layers / 3.0  # fwd+bwd ≈ 3× fwd: 2·MACs·3
    return CellProgram(
        name=f"{arch}:{shape_name}",
        kind="train",
        step_fn=gnn_train_step(model_mod, cfg, opt_cfg, n_graphs=shape["n_graphs"], blocked=blocked),
        abstract_args=(model, opt_abs, batch_abs),
        axes_trees=(p_axes, o_axes, b_axes),
        donate_argnums=(0, 1),
        meta=dict(
            n_nodes=shape["n_nodes"],
            n_edges=shape["n_edges"],
            model_flops=model_flops,
        ),
        param_tree=gnn_params_tree,
    )


def _tt_feats_abs(fields, batch: int):
    feats = {f.name: _meta((batch, f.multi_hot), torch.int32) for f in fields}
    axes = {f.name: ("batch", None) for f in fields}
    return feats, axes


def make_recsys_cell(cfg: tt.TwoTowerConfig, shape_name: str, opt_cfg: OptimizerConfig) -> CellProgram:
    sh = RECSYS_SHAPES[shape_name]
    b = sh["batch"]
    model = tt.TwoTower(cfg, device=META)
    params_abs = tt.params_tree(model)
    p_axes = generic_param_axes(params_abs)
    # embedding tables row-sharded
    for side in ("user_tables", "item_tables"):
        p_axes[side] = {k: ("rows", None) for k in p_axes[side]}

    ufe, ua = _tt_feats_abs(cfg.user_fields, b)
    ife, ia = _tt_feats_abs(cfg.item_fields, b)

    table_rows = sum(f.vocab for f in cfg.user_fields + cfg.item_fields)
    tower_macs = sum(
        a * bb for a, bb in zip(
            (len(cfg.user_fields) * cfg.embed_dim,) + cfg.tower_mlp[:-1], cfg.tower_mlp
        )
    ) * 2  # two towers
    common = dict(name=f"{cfg.name}:{shape_name}", param_tree=tt.params_tree)

    if sh["kind"] == "train":
        init_opt, _ = make_optimizer(opt_cfg)
        opt_abs = init_opt(params_abs)
        o_axes = opt_state_logical_axes(opt_cfg, p_axes)
        batch_abs = {"user": ufe, "item": ife, "log_q": _meta((b,), torch.float32)}
        b_axes = {"user": ua, "item": ia, "log_q": ("batch",)}
        model_flops = 6.0 * b * tower_macs + 6.0 * b * b * cfg.tower_mlp[-1]
        return CellProgram(
            kind="train",
            step_fn=recsys_train_step(cfg, opt_cfg),
            abstract_args=(model, opt_abs, batch_abs),
            axes_trees=(p_axes, o_axes, b_axes),
            donate_argnums=(0, 1),
            meta=dict(batch=b, table_rows=table_rows, model_flops=model_flops),
            **common,
        )

    if sh["kind"] == "serve":
        return CellProgram(
            kind="serve",
            step_fn=recsys_serve_step(cfg),
            abstract_args=(model, ufe, ife),
            axes_trees=(p_axes, ua, ia),
            meta=dict(batch=b, model_flops=2.0 * b * tower_macs),
            **common,
        )

    # retrieval scoring
    n_cand = sh["n_candidates"]

    def step(model, user, cands):
        vals, idx = model.score_candidates(user, cands, top_k=128)
        return vals, idx.to(torch.int32)  # lax.top_k's index type

    return CellProgram(
        kind="score",
        step_fn=step,
        abstract_args=(model, ufe, _meta((n_cand, cfg.tower_mlp[-1]), torch.float32)),
        axes_trees=(p_axes, ua, ("candidates", None)),
        meta=dict(
            batch=b,
            n_candidates=n_cand,
            model_flops=2.0 * b * (tower_macs / 2 + n_cand * cfg.tower_mlp[-1]),
        ),
        **common,
    )
