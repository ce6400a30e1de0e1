"""Device-dispatching scoring entry: pad the candidates to whole tiles,
score them (the CUDA kernel on a CUDA tensor, the plain version on a CPU
one and on a ``meta`` one, the dry-run's trace, where it computes nothing
and its product is counted), and reduce a hierarchical top-k, as the reference's ``score_topk``."""
from __future__ import annotations

import torch

from .scoring import CAND_TILE, scoring_cuda, scoring_plain

NEG = -3.0e38


def _scores(queries: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    if candidates.device.type == "cuda":
        return scoring_cuda(queries, candidates)
    if candidates.device.type in ("cpu", "meta"):  # meta: the dry-run's trace, shapes and FLOPs, no work
        return scoring_plain(queries, candidates)
    raise ValueError(f"scoring: unsupported device {candidates.device}")


def score_topk(queries: torch.Tensor, candidates: torch.Tensor, k: int = 128):
    """-> (scores [B, k], int64 indices [B, k]) over the candidate axis."""
    n, d = candidates.shape
    n_pad = -(-n // CAND_TILE) * CAND_TILE
    if n_pad != n:
        pad = torch.zeros(n_pad - n, d, dtype=candidates.dtype, device=candidates.device)
        candidates = torch.cat([candidates, pad])
    scores = _scores(queries, candidates)  # [B, n_pad]
    scores[:, n:] = NEG
    b = scores.shape[0]
    n_tiles = n_pad // CAND_TILE
    kk = min(k, CAND_TILE)
    # per-tile top-k ...
    tv, ti = _top(scores.view(b, n_tiles, CAND_TILE), kk)  # [B, T, kk]
    ti += torch.arange(n_tiles, device=ti.device).mul_(CAND_TILE)[None, :, None]
    # ... then reduce the [B, T*kk] shortlist, which is in column order
    # among equal scores, so equal scores stay in column order
    fv, fi = _top(tv.reshape(b, -1), k)
    return fv, torch.gather(ti.reshape(b, -1), 1, fi)


def _top(x: torch.Tensor, k: int):
    """The reference's ``lax.top_k`` along the last axis: the k largest,
    descending, equal values in ascending position. ``torch.topk`` leaves
    the order of equal values open (a corpus with repeated items has them),
    so this is a stable descending sort cut to k."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]
