"""Graph500's RMAT edge list, drawn on the device from the seed.

A frozen copy of the recipe the program's own smoke run uses: one uniform
draw a level picks the quadrant (A, B, C, D) and so one bit of each
endpoint; then a random permutation of the vertex ids, so that locality is
not an artefact of the generation order. Parameters: ``scale`` (V =
2^scale), ``edge_factor`` (E = V * edge_factor), ``a``, ``b``, ``c``.
"""
from __future__ import annotations

import torch

CHUNK = 1 << 27  # edges drawn at a time: bounds the uniform draws' memory


def generate(params: dict, seed: int, device: torch.device):
    scale, edge_factor = int(params["scale"]), int(params["edge_factor"])
    a, b, c = float(params["a"]), float(params["b"]), float(params["c"])
    gen = torch.Generator(device=device).manual_seed(seed)
    v, e = 1 << scale, (1 << scale) * edge_factor
    src = torch.zeros(e, dtype=torch.int32, device=device)
    dst = torch.zeros(e, dtype=torch.int32, device=device)
    ab, abc = a + b, a + b + c
    for c0 in range(0, e, CHUNK):
        s, d = src[c0 : c0 + CHUNK], dst[c0 : c0 + CHUNK]
        for bit in range(scale):
            r = torch.rand(s.shape[0], generator=gen, device=device)
            s |= (r >= ab).to(torch.int32) << bit                              # quadrants C and D
            d |= (((r >= a) & (r < ab)) | (r >= abc)).to(torch.int32) << bit  # B and D
    perm = torch.randperm(v, generator=gen, device=device).to(torch.int32)
    return perm[src.to(torch.int64)], perm[dst.to(torch.int64)], v
