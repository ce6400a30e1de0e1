# Hand-written CUDA kernels for Hopper (sm_90a), each as
# <name>/ {<name>.py (ctypes wrapper + launch count, plain PyTorch version),
# ops.py (layout builders, device dispatch), ref.py (plain-torch oracle)},
# sources under ../csrc/, built by _build.py at first use:
#   degree_count — the paper's §5.1 calibration histogram (int32 atomics)
#   spmv         — PR-pull aggregation / BFS expansion (ragged dst tiles)
from . import degree_count, spmv
