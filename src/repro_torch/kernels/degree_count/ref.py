"""Plain-torch oracle for the degree-count kernel."""
import torch


def degree_count_ref(ids: torch.Tensor, num_counters: int) -> torch.Tensor:
    """ids: [E] int32 (padding = -1, ignored). -> counts [num_counters] int32."""
    valid = ids >= 0
    return torch.bincount(ids[valid].to(torch.int64), minlength=num_counters).to(torch.int32)
