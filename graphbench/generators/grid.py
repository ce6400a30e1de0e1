"""A road-network stand-in: a ``side`` x ``side`` grid, each vertex joined
to its four neighbours in both directions (constant degree, long
diameter), with the vertex ids permuted from the seed."""
from __future__ import annotations

import torch


def generate(params: dict, seed: int, device: torch.device):
    side = int(params["side"])
    n = side * side
    vid = torch.arange(n, dtype=torch.int64, device=device).reshape(side, side)
    right_s, right_d = vid[:, :-1].reshape(-1), vid[:, 1:].reshape(-1)
    down_s, down_d = vid[:-1, :].reshape(-1), vid[1:, :].reshape(-1)
    src = torch.cat([right_s, right_d, down_s, down_d])
    dst = torch.cat([right_d, right_s, down_d, down_s])
    gen = torch.Generator(device=device).manual_seed(seed)
    perm = torch.randperm(n, generator=gen, device=device).to(torch.int32)
    return perm[src], perm[dst], n
