"""Shared two-tower training cases for the CPU tests, the card tests and
``chip_smoke.py``: seeded numpy batches, and one run of
``recsys_train_step`` on the card against the CPU. Imports no JAX (the
machine with the card has none)."""
from __future__ import annotations

import numpy as np
import torch

# loss and gradient norm: float32 sums in another order on the two devices
CARD_LOSS_RTOL, CARD_GNORM_RTOL = 1e-5, 1e-4
# weights after AdamW steps of lr 1e-3 from gradients that differ by
# float32 noise: within 1e-6 (tests/test_torch_gnn.py's card tolerance)
CARD_PARAM_ATOL = 1e-6
# AdamW's eps in the step comparisons, raised from 1e-8: a default-eps step
# of an element whose gradient is within float32 noise of zero may take
# either sign (tests/test_torch_train.py)
STEP_EPS = 1e-4


def make_batch(cfg, b: int, rng: np.random.Generator, *, weighted: bool = False) -> dict:
    """A training batch as numpy: ids uniform in each field's vocabulary,
    ``log_q`` a log-probability of each item, and (``weighted``) weights on
    the multi-hot fields, their last column 0 (the fixed hot-size's
    padding)."""
    def side(fields) -> dict:
        out = {f.name: rng.integers(0, f.vocab, (b, f.multi_hot)).astype(np.int32) for f in fields}
        if weighted:
            for f in fields:
                if f.multi_hot > 1:
                    w = rng.random((b, f.multi_hot)).astype(np.float32)
                    w[:, -1] = 0.0
                    out[f.name + "_w"] = w
        return out

    q = rng.random(b) + 0.1
    return {"user": side(cfg.user_fields), "item": side(cfg.item_fields),
            "log_q": np.log(q / q.sum() * b).astype(np.float32)}


def to_torch(batch: dict, device="cpu") -> dict:
    """The batch's numpy arrays as tensors on ``device``."""
    if isinstance(batch, dict):
        return {k: to_torch(v, device) for k, v in batch.items()}
    return torch.from_numpy(np.asarray(batch)).to(device)


def card_equals_cpu(device, rng: np.random.Generator, *, steps: int = 3, b: int = 64, seed: int = 0) -> dict:
    """``steps`` AdamW ``recsys_train_step``s of the two-tower smoke config
    on ``device`` and on the CPU from the same weights and batches: the same
    loss, gradient norm and weights after each step, and one EmbeddingBag
    kernel launch a field a step on the card. Raises on a difference past
    the tolerances; returns the readings."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    from repro_torch.launch.steps import recsys_train_step
    from repro_torch.models import recsys as tt
    from repro_torch.optim import OptimizerConfig, adamw_init

    cfg = get_arch("two-tower-retrieval").make_smoke_config()
    opt = OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=0, decay_steps=10, eps=STEP_EPS)
    cpu = tt.TwoTower(cfg, seed=seed, device="cpu")
    card = tt.TwoTower(cfg, seed=seed + 1, device=device)
    card.load_state_dict(cpu.state_dict())
    st_cpu, st_card = adamw_init(tt.params_tree(cpu)), adamw_init(tt.params_tree(card))
    step = recsys_train_step(cfg, opt)
    fields = len(cfg.user_fields) + len(cfg.item_fields)
    readings = []
    for _ in range(steps):
        batch = make_batch(cfg, b, rng)
        before = embedding_bag_cuda.launches
        card, st_card, m = step(card, st_card, to_torch(batch, device))
        torch.cuda.synchronize()
        if embedding_bag_cuda.launches != before + fields:
            raise AssertionError(f"a smoke step launched the kernel {embedding_bag_cuda.launches - before} "
                                 f"times, not once for each of the {fields} fields")
        cpu, st_cpu, want = step(cpu, st_cpu, to_torch(batch))
        torch.testing.assert_close(m["loss"].cpu(), want["loss"], rtol=CARD_LOSS_RTOL, atol=0)
        torch.testing.assert_close(m["gnorm"].cpu(), want["gnorm"], rtol=CARD_GNORM_RTOL, atol=0)
        err = 0.0
        for a, w in zip(tree_leaves(tt.params_tree(card)), tree_leaves(tt.params_tree(cpu))):
            torch.testing.assert_close(a.cpu(), w, rtol=0, atol=CARD_PARAM_ATOL)
            err = max(err, float((a.cpu() - w).abs().max()))
        readings.append({"loss": float(m["loss"]), "loss_cpu": float(want["loss"]),
                         "gnorm": float(m["gnorm"]), "gnorm_cpu": float(want["gnorm"]),
                         "weight_max_abs_diff": err})
    if int(st_card["step"]) != steps:
        raise AssertionError(f"the card's optimizer state counts {int(st_card['step'])} steps, not {steps}")
    return {"steps": readings, "batch": b}
