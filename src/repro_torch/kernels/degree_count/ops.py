"""Device-dispatching degree-count entry points: reduce ids modulo the
counter-array size (Eq. 11 semantics: counter per vertex id) and histogram
them with the CUDA kernel on a CUDA tensor, the plain version on a CPU one
(a ``meta`` one, the dry-run's, is returned as it is)."""
from __future__ import annotations

import torch

from .degree_count import degree_count_cuda, degree_count_plain


def count_into(ids: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Add the histogram of ``ids`` into ``counts`` (see ``degree_count.py``)."""
    if counts.device.type == "cuda":
        return degree_count_cuda(ids, counts)
    if counts.device.type == "cpu":
        return degree_count_plain(ids, counts)
    if counts.device.type == "meta":  # the dry-run's trace: the counters themselves, no work
        return counts
    raise ValueError(f"degree_count: unsupported device {counts.device}")


def degree_count(src: torch.Tensor, dst: torch.Tensor, num_counters: int) -> torch.Tensor:
    """Count edge-endpoint occurrences (src and dst) in a counter array."""
    ids = (torch.stack([src, dst]) % num_counters).to(torch.int32)
    counts = torch.zeros(num_counters, dtype=torch.int32, device=src.device)
    return count_into(ids, counts)
