from .ops import SpmvTiles, build_tiles, row_blocks, spmv, spmv_tiles
from .ref import spmv_ref
from .spmv import BLOCK_EDGES, DST_TILE, gather_probe_cuda, spmv_rows_cuda, spmv_rows_plain
