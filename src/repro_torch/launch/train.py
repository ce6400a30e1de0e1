"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs a real training loop on one device: config → ``TransformerLM`` with
float32 masters → ``lm_train_step`` → the token stream → the step loop
with checkpointing (the reference's format, so either package resumes the
other's run). Runs on the card unless ``device="cpu"`` / ``--device cpu``
is given; initial weights come from a ``torch.Generator`` seeded with 0.
"""
from __future__ import annotations

import argparse
import time

import torch


def build_small_lm(arch: str, *, scale: str = "smoke"):
    from repro_torch.configs import get_arch

    mod = get_arch(arch)
    if scale == "full":
        return mod.make_config()
    return mod.make_smoke_config()


def train_lm(
    cfg,
    *,
    steps: int,
    batch: int,
    seq: int,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    resume: bool = False,
    log_every: int = 10,
    optimizer: str = "adamw",
    lr: float = 3e-4,
    stop_after: int | None = None,  # simulate preemption (schedule unchanged)
    device=None,
) -> dict:
    """The reference's ``train_lm``: AdamW or Adafactor with warmup
    ``min(20, steps // 5 + 1)`` and cosine decay over ``steps``; a
    checkpoint of ``{"params", "opt"}`` (the reference's tree paths and
    stacked layouts) at every ``step % ckpt_every == 0`` past 0 and at the
    end; ``resume`` restores the latest one and the stream's cursor.
    Returns the logged ``(step, loss)`` pairs, tokens/s, the parameter tree
    (``params_tree``), the model, the optimizer state and each step's wall
    seconds."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data import TokenStream
    from repro_torch.graph.structure import resolve_device
    from repro_torch.launch.steps import lm_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import OptimizerConfig, make_optimizer, opt_state_from_jax

    dev = resolve_device(device)
    opt_cfg = OptimizerConfig(name=optimizer, lr=lr, warmup_steps=min(20, steps // 5 + 1), decay_steps=steps)
    init_opt, _ = make_optimizer(opt_cfg)
    model = tf.TransformerLM(cfg, seed=0, device=dev, masters=True)
    opt_state = init_opt(tf.params_tree(model))
    step_fn = lm_train_step(cfg, opt_cfg)

    stream = TokenStream(cfg.vocab, batch, seq)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr and resume and mgr.latest_step() is not None:
        state = mgr.restore({"params": tf.params_tree(model), "opt": opt_state})
        model.load_state_dict(tf.params_from_jax(cfg, state["params"]))
        opt_state = opt_state_from_jax(state["opt"], dev)
        start = mgr.latest_step()
        stream.step = start

    losses, step_s = [], []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    end = min(steps, stop_after) if stop_after is not None else steps
    for step in range(start, end):
        t_step = time.perf_counter()
        batch_np = next(stream)
        batch_dev = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        model, opt_state, metrics = step_fn(model, opt_state, batch_dev)
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            losses.append((step, loss))
            print(f"step {step:5d} loss {loss:8.4f} gnorm {float(metrics['gnorm']):7.3f}")
        if mgr and step > 0 and step % ckpt_every == 0:
            mgr.save(step, {"params": tf.params_tree(model), "opt": opt_state})
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t_step)
    if mgr:
        mgr.save(end, {"params": tf.params_tree(model), "opt": opt_state}, blocking=True)
    dt = time.time() - t0
    tokens = (end - start) * batch * seq
    return {
        "losses": losses,
        "tokens_per_s": tokens / max(dt, 1e-9),
        "params": tf.params_tree(model),
        "model": model,
        "opt_state": opt_state,
        "step_s": step_s,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)

    cfg = build_small_lm(args.arch, scale=args.scale)
    out = train_lm(
        cfg,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        ckpt_dir=args.ckpt_dir,
        resume=args.resume,
        device=args.device,
    )
    first, last = out["losses"][0][1], out["losses"][-1][1]
    print(f"done: loss {first:.3f} -> {last:.3f}; {out['tokens_per_s']:.0f} tok/s")
    return out


if __name__ == "__main__":
    main()
