"""Plain-torch oracle for candidate scoring: the full product, then top-k."""
import torch


def scoring_ref(queries: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    return queries.to(torch.float32) @ candidates.to(torch.float32).T


def topk_ref(queries: torch.Tensor, candidates: torch.Tensor, k: int):
    return torch.topk(scoring_ref(queries, candidates), k, dim=-1)
