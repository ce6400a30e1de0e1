"""Serving: the paper's scheduler applied to request admission.

Intra- vs inter-query parallelism maps onto serving as device-group width
vs concurrent request batches: a wide group answers one batch faster but
serves fewer batches at once. :func:`plan_group_width` uses the §3 cost
model and Algorithm 1's bounds to choose the width, falling back to
single-device groups under deep queues as §4.3 does. The widths are modeled
numbers under the hardware model passed in, not facts about any card: the
port has no TPU preset, so its callers pass ``core.XEON_E5_2660V4``, and
``ServingEngine`` takes ``hw`` as a required keyword where the reference
defaults to its TPU pod preset.

:class:`ServingEngine` is continuous batching over fixed decode slots on one
device; the planned width is recorded per tick, not applied.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.bounds import thread_bounds
from ..core.contention import HardwareModel
from ..core.cost_model import IterationWork
from ..core.descriptors import AlgorithmDescriptor, ItemCost
from ..models import transformer as tf

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


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


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


class ServingEngine:
    """Continuous batching over fixed decode slots (single-device execution;
    the planner's group width is recorded per tick). The KV cache is float32,
    as the reference's, on the model's device."""

    def __init__(
        self,
        cfg: tf.LMConfig,
        model: tf.TransformerLM,
        *,
        max_batch: int = 8,
        max_len: int = 1024,
        hw: HardwareModel,
        sample: Callable | None = None,
    ):
        self.cfg = cfg
        self.model = model
        self.max_batch = max_batch
        self.max_len = max_len
        self.hw = hw
        self.sample = sample or (lambda logits: torch.argmax(logits, dim=-1))
        self.device = model.device
        self.cache = tf.init_cache(cfg, max_batch, max_len, dtype=torch.float32, device=self.device)
        self.slots: list[Request | None] = [None] * max_batch
        self.queue: list[Request] = []
        self.tokens_out = 0
        self.plans: list[int] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for i in range(self.max_batch):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                # reset + prefill this slot: replay the prompt through masked
                # decode steps (only slot i advances), as the reference does;
                # the batched prefill path is models.transformer.prefill
                self.cache["len"][i] = 0
                advance = torch.zeros(self.max_batch, dtype=torch.bool, device=self.device)
                advance[i] = True
                tok = torch.zeros((self.max_batch, 1), dtype=torch.int32, device=self.device)
                for t in req.prompt[:-1]:
                    tok[i, 0] = int(t)
                    _, self.cache = tf.decode_step(self.cfg, self.model, tok, self.cache, advance=advance)

    def step(self) -> int:
        """One engine tick: admit, plan, decode one token for active slots."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        width = plan_group_width(
            self.hw,
            batch=len(active),
            cache_len=int(self.cache["len"].max()),
            n_kv_heads=self.cfg.n_kv_heads,
            head_dim=self.cfg.dh,
            n_layers=self.cfg.n_layers,
            queue_depth=len(self.queue) + 1,
        )
        self.plans.append(width)

        last = [
            (r.generated[-1] if r.generated else int(r.prompt[-1])) if r is not None else 0
            for r in self.slots
        ]
        last = torch.tensor(last, dtype=torch.int32, device=self.device)[:, None]
        advance = torch.zeros(self.max_batch, dtype=torch.bool, device=self.device)
        advance[active] = True
        logits, self.cache = tf.decode_step(self.cfg, self.model, last, self.cache, advance=advance)
        nxt = self.sample(logits).cpu().numpy()
        emitted = 0
        for i in active:
            req = self.slots[i]
            req.generated.append(int(nxt[i]))
            emitted += 1
            if len(req.generated) >= req.max_new_tokens:
                req.done = True
                self.slots[i] = None
        self.tokens_out += emitted
        return emitted

    def run_until_drained(self, max_ticks: int = 10_000) -> int:
        ticks = 0
        while (self.queue or any(self.slots)) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.tokens_out
