"""Host data pipeline: sharded synthetic token streams, the port of
``repro.train.data``.

Deterministic per (seed, step, host): every host materializes only its own
shard of the global batch (``process_index``-sliced), so the same code
drives 1-host CPU smoke tests and multi-host runs.  The batches are numpy
arrays, the reference's to the bit; the caller moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass
class ShardInfo:
    process_index: int = 0
    process_count: int = 1

    @classmethod
    def from_runtime(cls) -> "ShardInfo":
        """This process's rank and the world size of the initialised
        ``torch.distributed`` process group; ``(0, 1)`` without one."""
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            return cls(dist.get_rank(), dist.get_world_size())
        return cls()


class SyntheticLM:
    """Zipf-distributed token stream with weak bigram structure so that a
    few hundred training steps show a decreasing loss."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, shard: Optional[ShardInfo] = None):
        self.vocab = vocab_size
        self.seq = seq_len
        self.global_batch = global_batch
        self.shard = shard or ShardInfo()
        if global_batch % self.shard.process_count:
            raise ValueError("global_batch must divide evenly across hosts")
        self.local_batch = global_batch // self.shard.process_count
        self.seed = seed

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed, step, self.shard.process_index)
        )
        base = rng.zipf(1.3, size=(self.local_batch, self.seq)).astype(np.int64)
        tokens = base % self.vocab
        # bigram structure: even positions repeat a deterministic successor
        succ = (tokens * 2654435761 + 12345) % self.vocab
        tokens[:, 1::2] = np.where(
            rng.random((self.local_batch, self.seq // 2)) < 0.5,
            succ[:, 0::2][:, : self.seq // 2],
            tokens[:, 1::2],
        )
        return {"tokens": tokens.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
