"""Shared inputs of the GNN parity tests (``test_torch_gnn*.py``): the four
GNN archs' batches as numpy arrays, made from a seed as
``tests/test_arch_smoke.py`` makes them, and their conversion to each
package, and the case that holds a smoke config on the card against the
CPU. Imports no JAX, so the card tests and ``chip_smoke.py``'s phase 13
use it too."""
import importlib

import numpy as np
import torch

GNN_ARCHS = ["meshgraphnet", "graphcast", "pna", "schnet"]
MODEL_CLASS = {"meshgraphnet": "MeshGraphNet", "graphcast": "GraphCast", "pna": "PNA", "schnet": "SchNet"}
# the smoke batch of tests/test_arch_smoke.py: 48 nodes, 160 edges, 4 graphs
N_NODES, N_EDGES, N_GRAPHS = 48, 160, 4


def port_module(arch: str):
    return importlib.import_module(f"repro_torch.models.gnn.{arch}")


def gnn_batch(rng, n=N_NODES, e=N_EDGES, d_feat=16, d_edge=8, n_graphs=N_GRAPHS) -> dict:
    return dict(
        nodes=rng.normal(size=(n, d_feat)).astype(np.float32),
        src=rng.integers(0, n, e).astype(np.int32),
        dst=rng.integers(0, n, e).astype(np.int32),
        edge_feat=rng.normal(size=(e, d_edge)).astype(np.float32),
        node_mask=np.ones(n, bool),
        edge_mask=np.ones(e, bool),
        graph_ids=(np.arange(n) // (n // n_graphs)).clip(0, n_graphs - 1).astype(np.int32),
        n_graphs=n_graphs,
        positions=rng.normal(size=(n, 3)).astype(np.float32),
    )


def smoke_batch(arch: str, cfg, rng, n=N_NODES, e=N_EDGES, n_graphs=N_GRAPHS) -> dict:
    """``test_gnn_smoke_forward_and_grad``'s batch for ``arch``'s config."""
    if arch == "meshgraphnet":
        b = gnn_batch(rng, n, e, d_feat=cfg.d_node_in, d_edge=cfg.d_edge_in, n_graphs=n_graphs)
        b["targets"] = rng.normal(size=(n, cfg.d_out)).astype(np.float32)
    elif arch == "graphcast":
        b = gnn_batch(rng, n, e, d_feat=cfg.n_vars, d_edge=cfg.d_edge_in, n_graphs=n_graphs)
        b["targets"] = rng.normal(size=(n, cfg.n_vars)).astype(np.float32)
    elif arch == "pna":
        b = gnn_batch(rng, n, e, d_feat=cfg.d_node_in, d_edge=1, n_graphs=n_graphs)
        b["targets"] = rng.integers(0, cfg.n_classes, n).astype(np.int32)
    else:
        b = gnn_batch(rng, n, e, d_feat=1, d_edge=1, n_graphs=n_graphs)
        b["nodes"] = rng.integers(1, 10, (n, 1)).astype(np.float32)
        b["targets"] = rng.normal(size=(n_graphs,)).astype(np.float32)
    return b


def blocked_batch(rng, cfg, n=N_NODES, p=4, epb=48, fill=40) -> dict:
    """GraphCast's owner-blocked layout: ``p`` blocks of ``n // p`` nodes,
    ``fill`` valid edges a block whose ``dst_local`` lies in the block, the
    rest of ``epb`` masked padding (``src = dst_local = 0``)."""
    npb = n // p
    mask = np.zeros((p, epb), bool)
    mask[:, :fill] = True
    src = np.where(mask, rng.integers(0, n, (p, epb)), 0).astype(np.int32)
    dst_local = np.where(mask, rng.integers(0, npb, (p, epb)), 0).astype(np.int32)
    return dict(
        nodes=rng.normal(size=(n, cfg.n_vars)).astype(np.float32),
        src=src, dst_local=dst_local,
        edge_feat=rng.normal(size=(p, epb, cfg.d_edge_in)).astype(np.float32),
        edge_mask=mask, node_mask=np.ones(n, bool),
        graph_ids=np.zeros(n, np.int32), n_graphs=1,
        targets=rng.normal(size=(n, cfg.n_vars)).astype(np.float32),
    )


def flat_edges(b: dict) -> dict:
    """The blocked batch's edges as one flat list (``dst = p * N/P +
    dst_local``), for the unblocked forward."""
    p, epb = b["src"].shape
    npb = b["nodes"].shape[0] // p
    out = {k: v for k, v in b.items() if k not in ("src", "dst_local", "edge_feat", "edge_mask")}
    out["src"] = b["src"].reshape(-1)
    out["dst"] = (b["dst_local"] + np.arange(p)[:, None] * npb).reshape(-1).astype(np.int32)
    out["edge_feat"] = b["edge_feat"].reshape(p * epb, -1)
    out["edge_mask"] = b["edge_mask"].reshape(-1)
    return out


def to_torch(b: dict, device="cpu") -> dict:
    return {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v for k, v in b.items()}


def port_model(arch: str, cfg, state: dict | None = None, device="cpu", seed: int = 0):
    """The port's model of ``arch`` on ``device``, holding ``state`` (a state
    dict, e.g. ``params_from_jax``'s) where given."""
    mod = port_module(arch)
    model = getattr(mod, MODEL_CLASS[arch])(cfg, seed=seed, device=device)
    if state is not None:
        model.load_state_dict(state)
    return model


# the GNN step on the card against the CPU: the card's index_add and
# scatter_reduce add in atomic order, so sums differ in float32 order only;
# PNA's gradients carry float32 noise of up to ~1e-3 of a leaf's scale in
# either order (tests/test_torch_gnn.py), which moves its weights further
CARD_PARAM_ATOL = {"pna": 1e-5}
CARD_CASES = [("meshgraphnet", False), ("graphcast", False), ("graphcast", True), ("pna", False),
              ("schnet", False)]


def card_equals_cpu(arch: str, blocked: bool, device, rng, seed: int = 0) -> dict:
    """``arch``'s smoke config on ``device`` against the CPU on the same
    weights and batch (``blocked``: GraphCast's owner-blocked layout, P = 4):
    the forward, then one AdamW ``gnn_train_step`` (eps 1e-4, as in
    ``tests/test_torch_gnn_train.py``): its loss, gradient norm and weights.
    Raises on a difference past the tolerances; returns the readings."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import gnn_train_step
    from repro_torch.models.gnn.common import params_tree
    from repro_torch.optim import OptimizerConfig, adamw_init

    cfg = get_arch(arch).make_smoke_config()
    mod = port_module(arch)
    batch = blocked_batch(rng, cfg) if blocked else smoke_batch(arch, cfg, rng)
    cpu = port_model(arch, cfg, seed=seed)
    card = port_model(arch, cfg, cpu.state_dict(), device=device, seed=seed)
    fwd = mod.forward_blocked if blocked else mod.forward
    with torch.no_grad():  # an output near 0 is a sum of terms as large as the largest output
        want_out = fwd(cfg, cpu, to_torch(batch))
        out = fwd(cfg, card, to_torch(batch, device)).cpu()
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-5 * max(1.0, float(want_out.abs().max())))
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, decay_steps=10, eps=1e-4)
    step = gnn_train_step(mod, cfg, opt, n_graphs=batch["n_graphs"], blocked=blocked)
    card, card_st, m = step(card, adamw_init(params_tree(card)), to_torch(batch, device))
    cpu, _, want = step(cpu, adamw_init(params_tree(cpu)), to_torch(batch))
    assert next(card.parameters()).device.type == torch.device(device).type and int(card_st["step"]) == 1
    torch.testing.assert_close(m["loss"].cpu(), want["loss"], rtol=1e-5, atol=0)
    torch.testing.assert_close(m["gnorm"].cpu(), want["gnorm"], rtol=1e-4, atol=0)
    weight_err = 0.0
    for a, b in zip(tree_leaves(params_tree(card)), tree_leaves(params_tree(cpu))):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=CARD_PARAM_ATOL.get(arch, 1e-6))
        weight_err = max(weight_err, float((a.cpu() - b).abs().max()))
    return {"arch": arch, "blocked": blocked, "out_max_abs_diff": float((out - want_out).abs().max()),
            "loss": float(m["loss"]), "loss_cpu": float(want["loss"]),
            "gnorm": float(m["gnorm"]), "gnorm_cpu": float(want["gnorm"]), "weight_max_abs_diff": weight_err}
