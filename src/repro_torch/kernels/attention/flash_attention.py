"""Causal flash attention: the CUDA kernels' wrapper (the forward), their plain
version, and the plain blocked backward that ``ops.FlashAttention`` takes
for the gradient.

Replaces ``repro/kernels/attention/flash_attention.py::flash_attention_pallas``.
Both functions take the layer's layout as it is, ``q [B, S, H, Dh]`` and
``k, v [B, S, K, Dh]`` with ``H`` a multiple of ``K`` (query head ``h`` reads
KV head ``h // (H // K)``), any ``S``, and return ``[B, S, H, Dh]`` in q's
type: float32 scores ``q·kᵀ·Dh**-0.5`` masked to -1e30 above the diagonal, an
online softmax with float32 m/l/acc, and ``acc / max(l, 1e-30)``. At
``K == H`` this is ``flash_attention_pallas`` on the folded ``[B·H, S, Dh]``
layout.

bf16 and fp16 inputs go to the tensor-core kernel: ``wgmma`` products fed by
TMA, 128 query rows per block, ``BLOCK_K[Dh]`` keys per tile, the scale
applied to the float32 scores after the product, and P·V taken as two
16-bit products (``P_hi = 16-bit(p)``, ``P_lo = 16-bit(p - P_hi)``) into one
float32 accumulator, so P keeps ~16 bits where one 16-bit rounding would move
outputs past a bf16 step. TMA needs each input to start on a 16-byte
boundary: a view that does not raises a ``ValueError`` here rather than being
copied. float32 inputs go to a CUDA-core kernel of ``F32_BLOCK_Q`` rows and
``F32_BLOCK_K``-key tiles. The source and its design note are
``csrc/flash_attention.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check, load

BLOCK_Q = 128                          # bf16/fp16 kernel: query rows per CUDA block
BLOCK_K = {32: 128, 64: 128, 128: 64}  # its keys per tile, by head dim
F32_BLOCK_Q = 64                       # float32 kernel: query rows per block
F32_BLOCK_K = 64                       # its keys per tile
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)   # the head dims the kernels are built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_Q_TILES = 65535        # the grid's second axis


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, block_kv: int = 512
) -> torch.Tensor:
    """Plain PyTorch version: the blocked online softmax of the reference's
    ``blocked_causal_attention_gqa``, over KV blocks of ``block_kv`` keys,
    never holding more than ``[B, K, G, S, block_kv]`` scores. The query
    heads are grouped onto their KV head, so k and v are not expanded."""
    b, s, h, dh = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = dh**-0.5
    qt = q.reshape(b, s, kh, g, dh).permute(0, 2, 3, 1, 4).float() * scale  # [B,K,G,S,Dh]
    kt = k.permute(0, 2, 1, 3).float()                                       # [B,K,S,Dh]
    vt = v.permute(0, 2, 1, 3).float()
    q_pos = torch.arange(s, device=q.device)
    m = torch.full((b, kh, g, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kh, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kh, g, s, dh), dtype=torch.float32, device=q.device)
    # the reference pads the last block with masked keys; they add exp(-1e30 - m) = 0
    for c0 in range(0, s, block_kv):
        c1 = min(c0 + block_kv, s)
        scores = torch.einsum("bkgsd,bktd->bkgst", qt, kt[:, :, c0:c1])
        mask = torch.arange(c0, c1, device=q.device)[None, :] <= q_pos[:, None]
        scores = scores.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,bktd->bkgsd", p, vt[:, :, c0:c1])
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]                                 # [B,K,G,S,Dh]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh).to(q.dtype)


def flash_attention_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
    *, block_kv: int = 512,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of the blocked online softmax (dq, dk, dv in the inputs'
    types), in plain PyTorch on any device; float32 throughout, the query
    heads grouped onto their KV head (row ``s·G + g`` of a ``[B, K, S·G,
    Dh]`` view), over KV blocks of ``block_kv`` keys. The TPU kernel had no
    backward: the reference differentiates its pure-JAX twin.

    A first pass recomputes each row's max and sum (the forward returns
    neither), giving ``lse = m + log l``. Then with ``D = rowsum(dO ∘ O)``,
    per KV block ``[c0, c1)`` over the query rows from ``c0`` on (the rows
    before it see none of the block's keys): ``P = exp(S - lse)``,
    ``dV = Pᵀ dO``, ``dS = P ∘ (dO Vᵀ - D)``, ``dQ += dS K · scale``,
    ``dK = dSᵀ Q · scale``. Only the block's first ``c1 - c0`` positions
    need the causal mask. Peak scratch: two ``[B, K, S·G, block_kv]``
    float32 tensors."""
    b, s, h, dh = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = dh**-0.5

    def rows(x):  # [B, S, H, Dh] -> [B, K, S·G, Dh] float32
        return x.reshape(b, s, kh, g, dh).permute(0, 2, 1, 3, 4).reshape(b, kh, s * g, dh).float()

    qs = rows(q) * scale
    kt = k.float().permute(0, 2, 1, 3).contiguous()                     # [B,K,S,Dh]
    vt = v.float().permute(0, 2, 1, 3).contiguous()
    do = rows(dout)
    # a position's rows are s·G .. s·G + G-1: within a block's first rows,
    # row r sees key t (of the block) iff t <= r // G
    r_pos = torch.arange(block_kv * g, device=q.device) // g
    causal = torch.arange(block_kv, device=q.device)[None, :] <= r_pos[:, None]   # [bk·G, bk]

    def scores(c0: int, c1: int) -> torch.Tensor:
        sc = qs[:, :, c0 * g:] @ kt[:, :, c0:c1].transpose(-1, -2)       # [B,K,(S-c0)·G, c1-c0]
        diag = sc[:, :, : (c1 - c0) * g]
        diag.masked_fill_(~causal[: (c1 - c0) * g, : c1 - c0], NEG_INF)
        return sc

    m = torch.full((b, kh, s * g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kh, s * g), dtype=torch.float32, device=q.device)
    for c0 in range(0, s, block_kv):
        c1 = min(c0 + block_kv, s)
        sc = scores(c0, c1)
        m_old = m[:, :, c0 * g:]
        m_new = torch.maximum(m_old, sc.amax(dim=-1))
        l[:, :, c0 * g:] = l[:, :, c0 * g:] * torch.exp(m_old - m_new) + sc.sub_(m_new[..., None]).exp_().sum(-1)
        m[:, :, c0 * g:] = m_new
        del sc
    lse = m + torch.log(l.clamp_min(1e-30))
    delta = (do * rows(out)).sum(-1)                                     # [B,K,S·G]

    dq = torch.zeros_like(qs)
    dk = torch.empty_like(kt)
    dv = torch.empty_like(vt)
    for c0 in range(0, s, block_kv):
        c1 = min(c0 + block_kv, s)
        p = scores(c0, c1).sub_(lse[:, :, c0 * g:, None]).exp_()        # P
        dov = do[:, :, c0 * g:]
        dv[:, :, c0:c1] = p.transpose(-1, -2) @ dov
        ds = (dov @ vt[:, :, c0:c1].transpose(-1, -2)).sub_(delta[:, :, c0 * g:, None]).mul_(p)
        del p
        dq[:, :, c0 * g:] += ds @ kt[:, :, c0:c1]
        dk[:, :, c0:c1] = ds.transpose(-1, -2) @ qs[:, :, c0 * g:]
        del ds
    dq = (dq * scale).reshape(b, kh, s, g, dh).permute(0, 2, 1, 3, 4).reshape(b, s, h, dh)
    return dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype), dv.permute(0, 2, 1, 3).to(v.dtype)


def _lib() -> ctypes.CDLL:
    lib = load("flash_attention")
    fn = lib.flash_attention
    if fn.argtypes is None:  # first load: declare the C signature
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel for q's type on the current stream."""
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"flash_attention_cuda: {name} must be on a CUDA device with q, got {t.device}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise ValueError(
                f"flash_attention_cuda: q, k, v must share one of {list(_DTYPES)}, {name} is {t.dtype}"
            )
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} must be a contiguous 4-D tensor")
    b, s, h, dh = q.shape
    kh = k.shape[2]
    if k.shape != v.shape or (k.shape[0], k.shape[1], k.shape[3]) != (b, s, dh):
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} and k/v {tuple(k.shape)}/{tuple(v.shape)} disagree")
    if kh == 0 or h % kh != 0:
        raise ValueError(f"flash_attention_cuda: {h} query heads are no multiple of {kh} KV heads")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {dh} is not one of {HEAD_DIMS}")
    rows = F32_BLOCK_Q if q.dtype == torch.float32 else BLOCK_Q
    if -(-s // rows) > _MAX_Q_TILES:
        raise ValueError(f"flash_attention_cuda: at most {_MAX_Q_TILES * rows} positions per call")
    if q.dtype != torch.float32:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention_cuda: {name} must start on a 16-byte boundary (TMA)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    status = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, kh, dh,
        _DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
