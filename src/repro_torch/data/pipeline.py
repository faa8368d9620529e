"""Deterministic, shardable token data pipeline.

The port's own copy of the reference's numpy pipeline
(``src/repro/data/pipeline.py``), so that the port imports nothing of the
JAX package: the same generators on the same seeds, so every batch equals
the reference's bit for bit.

Two sources behind one interface:

  * ``SyntheticLM``   — seeded Zipfian token stream (rank-frequency
    structure, not uniform noise);
  * ``MemmapTokens``  — flat binary token file (``np.memmap``), the
    "tokenized corpus on shared storage" layout.

Batch ``i`` is a pure function of (seed, step, host): after a restart the
pipeline resumes from the step recorded in the checkpoint with no stream
state to persist.  Each host materializes only its ``(host_id,
num_hosts)`` slice of the global batch (``local_batch``).  Batches are
numpy int32 arrays; the caller moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticLM", "MemmapTokens", "make_batches"]


def _local_batch(global_batch: int, num_hosts: int) -> int:
    if global_batch % num_hosts:
        raise ValueError(
            f"global batch {global_batch} does not split over {num_hosts} hosts")
    return global_batch // num_hosts


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    host_id: int = 0
    num_hosts: int = 1

    @property
    def local_batch(self) -> int:
        return _local_batch(self.global_batch, self.num_hosts)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        # Zipf over a capped support, mapped into the vocab.
        raw = rng.zipf(self.zipf_a, size=(self.local_batch, self.seq_len + 1))
        tokens = (raw - 1) % self.vocab_size
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }


@dataclasses.dataclass
class MemmapTokens:
    path: str
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")
        n_seqs = (len(self._data) - 1) // self.seq_len
        if n_seqs < 1:
            raise ValueError(f"{self.path}: too small for seq_len={self.seq_len}")
        self._n_seqs = n_seqs

    @property
    def local_batch(self) -> int:
        return _local_batch(self.global_batch, self.num_hosts)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        idx = rng.integers(0, self._n_seqs, size=self.local_batch)
        starts = idx * self.seq_len
        tok = np.stack(
            [self._data[s: s + self.seq_len + 1] for s in starts]
        ).astype(np.int32)
        tok %= self.vocab_size
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def make_batches(source, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield source.batch(step)
        step += 1
