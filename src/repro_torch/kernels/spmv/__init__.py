from .ops import SpmvTiles, build_tiles, spmv, spmv_tiles
from .ref import spmv_ref
from .spmv import DST_TILE, LONG_ROW, spmv_rows_cuda, spmv_rows_plain
