"""Deterministic, shardable synthetic token pipeline with prefetch -- a
copy of ``repro/data/pipeline.py`` (numpy only; the port imports nothing
of the reference), so batches equal the reference's byte for byte.

Determinism contract (fault tolerance depends on it): batch content is a
pure function of (seed, step, shard) -- after a restart/restore at step k
the stream continues bit-identically, and no two data shards overlap.
Documents of random length are packed back-to-back with EOS separators
(realistic packing; the "labels" are next-token shifted).

`Prefetcher` is the straggler-mitigation piece on the input side: a
background thread keeps `depth` batches ready so a slow host never stalls
the step loop on data (see train/straggler.py for the launcher-side logic).
Batches are numpy arrays; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "Prefetcher"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_shards: int = 1
    seed: int = 0
    eos_id: int = 0
    mean_doc_len: int = 256


class SyntheticLM:
    """Deterministic synthetic LM batches; shard-disjoint by construction."""

    def __init__(self, cfg: DataConfig, shard: int = 0):
        if cfg.global_batch % cfg.num_shards:
            raise ValueError("global_batch % num_shards != 0")
        self.cfg = cfg
        self.shard = shard
        self.local_batch = cfg.global_batch // cfg.num_shards

    def _rng(self, step: int, row: int):
        c = self.cfg
        # distinct counter per (seed, step, global row): SeedSequence keys
        return np.random.default_rng(
            np.random.SeedSequence((c.seed, step, self.shard *
                                    self.local_batch + row)))

    def batch_at(self, step: int):
        """-> {"tokens": (B_loc, S) int32, "labels": (B_loc, S) int32}."""
        c = self.cfg
        toks = np.empty((self.local_batch, c.seq_len + 1), np.int32)
        for row in range(self.local_batch):
            rng = self._rng(step, row)
            out = []
            while len(out) < c.seq_len + 1:
                n = int(rng.exponential(c.mean_doc_len)) + 1
                out.extend(rng.integers(1, c.vocab_size,
                                        size=min(n, c.seq_len + 1 - len(out)
                                                 )).tolist())
                if len(out) < c.seq_len + 1:
                    out.append(c.eos_id)
            toks[row] = out[: c.seq_len + 1]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Background-thread batch prefetch (depth-bounded queue)."""

    def __init__(self, stream: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.stream = stream
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._next
        while not self._stop.is_set():
            batch = self.stream.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
