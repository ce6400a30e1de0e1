"""Unblocked causal-attention oracle."""
import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q/k/v: [BH, S, D] -> [BH, S, D] (float32 math)."""
    bh, s, d = q.shape
    scores = torch.einsum("bsd,btd->bst", q.float(), k.float()) * d**-0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bst,btd->bsd", p, v.float()).to(q.dtype)
