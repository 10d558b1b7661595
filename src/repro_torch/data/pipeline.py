"""Deterministic, restartable synthetic data pipeline (twin of
``repro.data.pipeline``).

Batches are a pure function of (seed, step, host), so a restarted job
resumes at step k with bitwise the same data: no replayed or dropped
batches and no loader state in the checkpoint. Per-host sharding slices
the global batch by host index (``num_hosts`` defaults to 1: nothing
here reads a process group); a background thread prefetches.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.data import synthetic
from repro_torch.models.config import ModelConfig


class SyntheticTokenPipeline:
    def __init__(self, cfg: ModelConfig, seq_len: int, global_batch: int, *,
                 seed: int = 1234, num_hosts: int = 1, host_index: int = 0,
                 prefetch: int = 2):
        self.cfg = cfg
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_index = host_index
        assert global_batch % self.num_hosts == 0
        self.host_batch = global_batch // self.num_hosts
        self.prefetch = prefetch

    def batch_for_step(self, step: int) -> dict:
        """Pure function of (seed, step, host): the restart contract."""
        mix = np.uint32(
            (self.seed * 2654435761 + step * 40503 + self.host_index * 97)
            % (2 ** 31))
        return synthetic.make_batch(self.cfg, self.seq_len, self.host_batch,
                                    kind="train", seed=int(mix))

    def iterate(self, start_step: int = 0) -> Iterator[tuple[int, dict]]:
        """Prefetching iterator from ``start_step`` (skipping ahead is
        O(1): batches are stateless in the step index)."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            s = start_step
            while not stop.is_set():
                q.put((s, self.batch_for_step(s)))
                s += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            try:
                q.get_nowait()       # unblock the producer
            except queue.Empty:
                pass
