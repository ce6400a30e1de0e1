from .registry import ASSIGNED_ARCHS, all_cells, arch_shapes, get_arch
