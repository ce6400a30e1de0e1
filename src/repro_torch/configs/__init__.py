from .registry import PORTED_ARCHS, get_arch
