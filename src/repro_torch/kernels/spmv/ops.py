"""Ragged dst-tile layout builder and the device-dispatching SpMV entry.

The TPU kernel's layout padded every 512-target tile to the fullest tile's
edge count; on RMAT graphs that is several times the edge count (about 10x
at 2^20 vertices). This layout keeps what that kernel computes and drops the
padding: edges stably sorted by target, one int64 offset per target row
(rows padded up to whole tiles, the pad rows empty), int32 source ids. A
tile range ``[a, b)`` is the row range ``[a * DST_TILE, b * DST_TILE)``,
i.e. a slice of the offsets.

For the CUDA kernel the layout also cuts each tile's rows into blocks of
about equal work (``row_blocks``): a tile range is the block range
``[tile_blocks[a], tile_blocks[b])``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .spmv import BLOCK_EDGES, DST_TILE, spmv_rows_cuda, spmv_rows_plain


@dataclasses.dataclass(frozen=True)
class SpmvTiles:
    """One edge list in the ragged dst-tile layout, on one device."""

    row_ptr: torch.Tensor          # [n_tiles * DST_TILE + 1] int64 offsets into src
    src: torch.Tensor              # [E] int32 source ids, stably sorted by target
    blocks: torch.Tensor           # [2, NB + 1] int32: first row of each block (then the
                                   # row count), piece of a long row (-1: whole rows)
    tile_blocks: np.ndarray        # [n_tiles + 1] on the host: tile t holds blocks [tb[t], tb[t+1])
    scratch: torch.Tensor          # [2, NB] int32: the kernel's partials and counters, zero
    num_vertices: int

    @property
    def n_tiles(self) -> int:
        return (self.row_ptr.shape[0] - 1) // DST_TILE

    @property
    def n_blocks(self) -> int:
        return self.blocks.shape[1] - 1


def row_blocks(row_ptr: torch.Tensor, block_edges: int = BLOCK_EDGES) -> tuple[torch.Tensor, torch.Tensor]:
    """Cut the rows of ``row_ptr`` (whole tiles) into blocks for the kernel,
    in O(rows) tensor operations on its device.

    A row of more than ``block_edges / 2`` edges is a block of its own, or,
    past ``block_edges``, ``ceil(len / block_edges)`` pieces. The other rows
    go together while their first edges fall in the same ``block_edges / 2``
    span of their tile, so a block holds at most ``block_edges - 1`` edges.
    Every tile starts a block. Returns ``blocks`` (int32 ``[2, NB + 1]``:
    each block's first row then the row count; each block's piece index, -1
    for whole rows, then -1) and ``tile_blocks`` (int64 ``[T + 1]``). The
    kernel takes blocks of ``BLOCK_EDGES``; ``tools/spmv_ab.py`` cuts others
    for its variants."""
    dev = row_ptr.device
    n_rows = row_ptr.shape[0] - 1
    n_tiles = n_rows // DST_TILE
    half = block_edges // 2
    counts = row_ptr[1:] - row_ptr[:-1]
    rows = torch.arange(n_rows, device=dev)
    start = row_ptr[:-1] - row_ptr[rows - rows % DST_TILE]  # first edge, from the tile's start
    big = counts > half
    span = start // half
    first = torch.ones(n_rows, dtype=torch.bool, device=dev)
    first[1:] = (span[1:] != span[:-1]) | big[1:] | big[:-1]
    first[::DST_TILE] = True
    starts = torch.nonzero(first).flatten()
    len0 = counts[starts]
    pieces = torch.where(len0 > block_edges, -(-len0 // block_edges), 1)
    total = int(pieces.sum())
    block_row = torch.repeat_interleave(starts, pieces, output_size=total)
    owner = torch.repeat_interleave(torch.arange(starts.shape[0], device=dev), pieces, output_size=total)
    k = torch.arange(total, device=dev) - (torch.cumsum(pieces, 0) - pieces)[owner]
    piece = torch.where(pieces[owner] > 1, k, -1)
    blocks = torch.stack([
        torch.cat([block_row, torch.tensor([n_rows], device=dev)]),
        torch.cat([piece, torch.tensor([-1], device=dev)]),
    ]).to(torch.int32).contiguous()
    per_tile = torch.bincount(block_row // DST_TILE, minlength=n_tiles)
    tile_blocks = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(per_tile, 0)])
    return blocks, tile_blocks


def build_tiles(src: torch.Tensor, dst: torch.Tensor, num_vertices: int) -> SpmvTiles:
    """Sort edges stably by target and build the ragged tile layout, with
    its row blocks of at most ``BLOCK_EDGES`` edges, on the edges' device."""
    dev = src.device
    n_tiles = max(-(-num_vertices // DST_TILE), 1)
    n_rows = n_tiles * DST_TILE
    dst64 = dst.to(torch.int64)
    order = torch.argsort(dst64, stable=True)
    counts = torch.bincount(dst64, minlength=n_rows)
    row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), counts.cumsum(0)])
    blocks, tile_blocks = row_blocks(row_ptr)
    return SpmvTiles(
        row_ptr=row_ptr,
        src=src[order].to(torch.int32).contiguous(),
        blocks=blocks,
        tile_blocks=tile_blocks.cpu().numpy(),
        scratch=torch.zeros(2, blocks.shape[1] - 1, dtype=torch.int32, device=dev),
        num_vertices=int(num_vertices),
    )


def spmv_tiles(
    tables: SpmvTiles, contrib: torch.Tensor, t0: int, t1: int, out: torch.Tensor | None = None
) -> torch.Tensor:
    """Per-target sums for tiles [t0, t1) of ``tables``: ``[t1 - t0, DST_TILE]``
    float32, zeros for targets past the last vertex. ``out``, when given, is
    a contiguous float32 view of exactly those ``(t1 - t0) * DST_TILE`` rows
    that the sums are written into (and the result views) instead of a new
    tensor. A CUDA tensor goes to the kernel, a CPU tensor to the plain
    version; a ``meta`` tensor gets the output's shape alone."""
    r0, r1 = t0 * DST_TILE, t1 * DST_TILE
    if contrib.device.type == "cuda":
        out = spmv_rows_cuda(
            tables.row_ptr, tables.src, contrib, tables.blocks, tables.scratch,
            block_lo=int(tables.tile_blocks[t0]), block_hi=int(tables.tile_blocks[t1]),
            row_base=r0, n_rows=r1 - r0, out=out,
        )
    elif contrib.device.type == "cpu":
        out = spmv_rows_plain(tables.row_ptr[r0 : r1 + 1], tables.src, contrib, out)
    elif contrib.device.type == "meta":  # the dry-run's trace: the plain version's shape and type, no work
        out = contrib.new_empty(r1 - r0) if out is None else out
    else:
        raise ValueError(f"spmv: unsupported device {contrib.device}")
    return out.reshape(t1 - t0, DST_TILE)


def spmv(tables: SpmvTiles, contrib: torch.Tensor) -> torch.Tensor:
    """contrib [V] -> aggregated [num_vertices] (PR-pull inner product)."""
    out = spmv_tiles(tables, contrib, 0, tables.n_tiles)
    return out.reshape(-1)[: tables.num_vertices]
