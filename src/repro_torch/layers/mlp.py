"""Feed-forward blocks: SwiGLU (llama family) and GELU MLP. Their products
are plain ``torch.matmul``, as the reference leaves them to XLA."""
from __future__ import annotations

import torch
from torch.nn import functional as F


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    """params: wi_gate [D,F], wi_up [D,F], wo [F,D]."""
    g = x @ params["wi_gate"]
    u = x @ params["wi_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ params["wo"]


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    h = x @ params["wi"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)  # jax.nn.gelu's default form
    return h @ params["wo"]


def mlp_2layer(params, x: torch.Tensor, *, activation=torch.relu) -> torch.Tensor:
    """Generic 2-layer MLP used by the GNN blocks (wi [I,H], wo [H,O])."""
    h = activation(x @ params["wi"] + params["bi"])
    return h @ params["wo"] + params["bo"]
