"""Plain-torch oracle for the SpMV kernel: segment sum over COO."""
import torch


def spmv_ref(src: torch.Tensor, dst: torch.Tensor, contrib: torch.Tensor, num_vertices: int) -> torch.Tensor:
    vals = contrib[src.to(torch.int64)]
    out = torch.zeros(num_vertices, dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, dst.to(torch.int64), vals)
