"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Brings up the continuous-batching engine on a reduced config and runs a
synthetic request trace through it, reporting aggregate token throughput and
the group-width plans the paper's scheduler produced along the way (under
the Xeon hardware model: the port has no TPU preset). Runs on the card
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.core import XEON_E5_2660V4
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving import Request, ServingEngine

    cfg = get_arch(args.arch).make_smoke_config()
    model = TransformerLM(cfg, seed=0, device=args.device)
    engine = ServingEngine(cfg, model, max_batch=args.max_batch, max_len=256, hw=XEON_E5_2660V4)

    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        prompt = rng.integers(1, cfg.vocab, size=rng.integers(4, 12)).astype(np.int32)
        engine.submit(Request(rid, prompt, max_new_tokens=args.max_new_tokens))

    t0 = time.perf_counter()
    total = engine.run_until_drained()
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    plans = dict(collections.Counter(engine.plans))
    print(
        f"served {args.requests} requests, {total} tokens in {dt:.2f}s on {model.device} "
        f"({total/dt:.1f} tok/s); group-width plan histogram (Xeon model): {plans}"
    )
    return {"tokens": total, "seconds": dt, "plans": plans}


if __name__ == "__main__":
    main()
