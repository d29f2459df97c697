"""Deterministic synthetic token pipeline with host-side prefetch (the
port's numpy copy of ``repro/data/pipeline.py``; the same batches bit for
bit).

Zipf-distributed token ids (matching the skew the embedding tier exploits),
next-token labels, deterministic per (seed, step) — restart-safe: resuming
from step N reproduces exactly the batches a fault interrupted.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, zipf_s: float = 1.2):
        self.vocab, self.seq, self.batch = vocab, seq_len, global_batch
        self.seed = seed
        ranks = np.arange(1, vocab + 1)
        p = 1.0 / ranks ** zipf_s
        self.p = p / p.sum()

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        tokens = rng.choice(self.vocab, size=(self.batch, self.seq),
                            p=self.p).astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((self.batch, 1), -1, np.int32)], axis=1)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Double-buffered host prefetch thread."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            try:
                self.q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
