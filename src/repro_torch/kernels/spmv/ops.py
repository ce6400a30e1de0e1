"""Ragged dst-tile layout builder and the device-dispatching SpMV entry.

The TPU kernel's layout padded every 512-target tile to the fullest tile's
edge count; on RMAT graphs that is several times the edge count (about 10x
at 2^20 vertices). This layout keeps what that kernel computes and drops the
padding: edges stably sorted by target, one int64 offset per target row
(rows padded up to whole tiles, the pad rows empty), int32 source ids. A
tile range ``[a, b)`` is the row range ``[a * DST_TILE, b * DST_TILE)``,
i.e. a slice of the offsets.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .spmv import DST_TILE, LONG_ROW, spmv_rows_cuda, spmv_rows_plain


@dataclasses.dataclass(frozen=True)
class SpmvTiles:
    """One edge list in the ragged dst-tile layout, on one device."""

    row_ptr: torch.Tensor          # [n_tiles * DST_TILE + 1] int64 offsets into src
    src: torch.Tensor              # [E] int32 source ids, stably sorted by target
    long_rows: torch.Tensor        # [L] int32 rows with > LONG_ROW edges, ascending
    long_rows_host: np.ndarray     # the same rows on the host (range lookups)
    num_vertices: int

    @property
    def n_tiles(self) -> int:
        return (self.row_ptr.shape[0] - 1) // DST_TILE

    def _long_span(self, r0: int, r1: int) -> tuple[int, int]:
        """Index span of the long rows inside rows [r0, r1)."""
        lo, hi = np.searchsorted(self.long_rows_host, [r0, r1], side="left")
        return int(lo), int(hi)

    def slab(self, a: int, b: int) -> "SpmvTiles":
        """A standalone copy of tiles [a, b) (offsets rebased to 0): the
        state a locality domain owning those targets would hold."""
        r0, r1 = a * DST_TILE, b * DST_TILE
        row_ptr = self.row_ptr[r0 : r1 + 1]
        e0, e1 = int(row_ptr[0]), int(row_ptr[-1])
        i0, i1 = self._long_span(r0, r1)
        return SpmvTiles(
            row_ptr=(row_ptr - e0).contiguous(),
            src=self.src[e0:e1].clone(),
            long_rows=(self.long_rows[i0:i1] - r0).contiguous(),
            long_rows_host=self.long_rows_host[i0:i1] - r0,
            num_vertices=max(min(self.num_vertices - r0, r1 - r0), 0),
        )


def build_tiles(src: torch.Tensor, dst: torch.Tensor, num_vertices: int) -> SpmvTiles:
    """Sort edges stably by target and build the ragged tile layout on the
    edges' device."""
    dev = src.device
    n_tiles = max(-(-num_vertices // DST_TILE), 1)
    n_rows = n_tiles * DST_TILE
    dst64 = dst.to(torch.int64)
    order = torch.argsort(dst64, stable=True)
    counts = torch.bincount(dst64, minlength=n_rows)
    row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), counts.cumsum(0)])
    long_rows = torch.nonzero(counts > LONG_ROW).flatten().to(torch.int32)
    return SpmvTiles(
        row_ptr=row_ptr,
        src=src[order].to(torch.int32).contiguous(),
        long_rows=long_rows,
        long_rows_host=long_rows.cpu().numpy(),
        num_vertices=int(num_vertices),
    )


def spmv_tiles(tables: SpmvTiles, contrib: torch.Tensor, t0: int, t1: int) -> torch.Tensor:
    """Per-target sums for tiles [t0, t1) of ``tables``: ``[t1 - t0, DST_TILE]``
    float32, zeros for targets past the last vertex. A CUDA tensor goes to
    the kernel, a CPU tensor to the plain version."""
    r0, r1 = t0 * DST_TILE, t1 * DST_TILE
    row_ptr = tables.row_ptr[r0 : r1 + 1]
    if contrib.device.type == "cuda":
        i0, i1 = tables._long_span(r0, r1)
        out = spmv_rows_cuda(
            row_ptr, tables.src, contrib, tables.long_rows[i0:i1], row_base=r0
        )
    elif contrib.device.type == "cpu":
        out = spmv_rows_plain(row_ptr, tables.src, contrib)
    else:
        raise ValueError(f"spmv: unsupported device {contrib.device}")
    return out.reshape(t1 - t0, DST_TILE)


def spmv(tables: SpmvTiles, contrib: torch.Tensor) -> torch.Tensor:
    """contrib [V] -> aggregated [num_vertices] (PR-pull inner product)."""
    out = spmv_tiles(tables, contrib, 0, tables.n_tiles)
    return out.reshape(-1)[: tables.num_vertices]
