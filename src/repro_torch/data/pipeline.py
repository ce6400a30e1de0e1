"""Data pipelines: deterministic, restartable, host-side (the reference's
``repro.data.pipeline``, copied: the port imports nothing of the JAX
package). Given the same seed and step, each stream yields the same numbers
as the reference's.

  * TokenStream      — synthetic LM token batches (zipfian unigram mix),
    numpy arrays, with a saved cursor so a restart resumes mid-epoch;
  * GraphBatchStream — neighbour-sampled graph batches for GNN training on
    the port's ``graph.sampler``: the block's tensors on ``device`` (the
    card unless the caller names another), features beside them;
  * InteractionStream — recsys (user, item) id batches with logQ
    estimates, numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np
import torch

from ..graph.sampler import block_to_device, sample_fanout
from ..graph.structure import Graph


@dataclasses.dataclass
class TokenStream:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    step: int = 0  # restart cursor

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_state(cls, vocab: int, batch: int, seq: int, state: dict) -> "TokenStream":
        return cls(vocab, batch, seq, seed=state["seed"], step=state["step"])

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        # zipf-ish unigram distribution, clipped to vocab
        toks = rng.zipf(1.3, size=(self.batch, self.seq + 1)) % self.vocab
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


@dataclasses.dataclass
class GraphBatchStream:
    graph: Graph
    batch_nodes: int
    fanouts: tuple
    d_feat: int
    seed: int = 0
    step: int = 0
    device: Any = None  # where the batch's tensors go: the card unless named

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        seeds = rng.choice(self.graph.num_vertices, size=self.batch_nodes, replace=False)
        block = sample_fanout(self.graph, seeds, self.fanouts, seed=self.step)
        dev = block_to_device(block, device=self.device)
        n = dev["nodes"].shape[0]
        feats = rng.normal(size=(n, self.d_feat)).astype(np.float32)
        return dict(dev, feats=torch.from_numpy(feats).to(dev["nodes"].device))


@dataclasses.dataclass
class InteractionStream:
    n_users: int
    n_items: int
    batch: int
    hist_len: int = 32
    seed: int = 0
    step: int = 0

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        # zipfian item popularity -> logQ correction from the same law
        items = (rng.zipf(1.2, size=self.batch) % self.n_items).astype(np.int32)
        ranks = items.astype(np.float64) + 1.0
        q = (1.0 / ranks ** 1.2)
        log_q = np.log(q / q.sum() * self.batch).astype(np.float32)
        return {
            "user": {
                "user_id": rng.integers(0, self.n_users, (self.batch, 1)).astype(np.int32),
                "user_history": (rng.zipf(1.2, size=(self.batch, self.hist_len)) % self.n_items).astype(np.int32),
            },
            "item": {"item_id": items[:, None]},
            "log_q": log_q,
        }
