"""Serving: the paper's scheduler applied to request admission.

Intra- vs inter-query parallelism maps onto serving as device-group width
vs concurrent request batches: a wide group answers one batch faster but
serves fewer batches at once. :func:`plan_group_width` uses the §3 cost
model and Algorithm 1's bounds to choose the width, falling back to
single-device groups under deep queues as §4.3 does. The widths are modeled
numbers under the hardware model passed in, not facts about any card: the
port has no TPU preset, so its callers pass ``core.XEON_E5_2660V4``.
``Request`` and ``ServingEngine`` (LM decoding) wait for the transformer
slice.
"""
from __future__ import annotations

from ..core.bounds import thread_bounds
from ..core.contention import HardwareModel
from ..core.cost_model import IterationWork
from ..core.descriptors import AlgorithmDescriptor, ItemCost

# Descriptor for one decode step: per "vertex" (= request slot) the cost is
# dominated by streaming the KV cache + weights; the combine across a group
# is the atomic analogue.
DECODE_STEP = AlgorithmDescriptor(
    name="lm_decode_step",
    kind="data_driven",
    push=True,
    v=ItemCost(n_ops=2, n_mem=2, n_atomics=0),
    e=ItemCost(n_ops=2, n_mem=1, n_atomics=0),   # per KV entry touched
    f=ItemCost(n_ops=0, n_mem=1, n_atomics=1),   # per output elem combined
    bytes_per_touched=2,
    bytes_per_vertex_private=4,
)


def plan_group_width(
    hw: HardwareModel,
    *,
    batch: int,
    cache_len: int,
    n_kv_heads: int,
    head_dim: int,
    n_layers: int,
    queue_depth: int,
) -> int:
    """Paper Eq. 9/10 + Algorithm 1 applied to one step.

    Work items = KV entries touched per step; M = KV bytes. Under deep
    queues the pool pressure shrinks grants, so the request is capped at
    P / queue_depth (inter-query fairness, §4.3)."""
    kv_entries = float(batch * cache_len * n_kv_heads * n_layers)
    m_bytes = kv_entries * head_dim * 2
    work = IterationWork(
        frontier=float(batch),
        edges=kv_entries,
        found=float(batch * n_layers),
        touched=kv_entries,
        m_bytes=min(m_bytes, hw.levels[-1].capacity * 0.9),
    )
    tb = thread_bounds(DECODE_STEP, hw, work)
    if not tb.parallel:
        return 1
    fair_cap = max(hw.max_threads // max(queue_depth, 1), 1)
    return int(max(min(tb.t_max, fair_cap), 1))
