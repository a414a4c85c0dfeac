"""Data pipeline (the port's counterpart of ``repro.data.pipeline``):
the deterministic synthetic source and host-side prefetch.

The sampler is a pure function of (seed, step), drawn from numpy's Philox
stream exactly as the JAX package draws it, so both packages see the same
batches bit for bit, and a restart resumes the same token stream. The
memory-mapped ``TokenFile`` source is not ported yet (ROADMAP.md §A).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import startrail as st


class SyntheticLM:
    """Deterministic synthetic next-token data (self-supervised layout)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                 seq_scheme: str = "zigzag", sp_size: int = 1):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.scheme = seq_scheme
        self.positions = np.stack([
            st.shard_positions(p, shape.seq_len, sp_size, seq_scheme).numpy()
            for p in range(sp_size)])
        self.perm = self.positions.reshape(-1)

    def _tokens(self, step: int) -> np.ndarray:
        rng = np.random.Generator(np.random.Philox(key=self.seed + step))
        b, s = self.shape.global_batch, self.shape.seq_len
        # markov-ish stream so the loss is learnable (not pure noise)
        base = rng.integers(0, self.cfg.vocab_size, size=(b, s // 8),
                            dtype=np.int64)
        toks = np.repeat(base, 8, axis=1)
        noise = rng.integers(0, self.cfg.vocab_size, size=(b, s))
        flip = rng.random((b, s)) < 0.1
        toks = np.where(flip, noise, toks)
        return toks.astype(np.int32)

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        toks = self._tokens(step)
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        batch = {
            "tokens": np.take(toks, self.perm, axis=1),
            "labels": np.take(labels, self.perm, axis=1),
        }
        if self.cfg.frontend_stub is not None:
            rng = np.random.Generator(np.random.Philox(key=99 + step))
            batch["frontend_emb"] = rng.standard_normal(
                (self.shape.global_batch, self.shape.seq_len,
                 self.cfg.d_model), dtype=np.float32)
        return batch


class Prefetcher:
    """Background-thread prefetch of the next `depth` batches. A source
    that raises hands its exception to ``next`` instead of leaving it
    waiting."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        s = self.step
        while not self._stop.is_set():
            try:
                item = (s, self.source.get_batch(s))
            except Exception as e:  # noqa: BLE001 (re-raised by next)
                item = (s, e)
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(item[1], Exception):
                return
            s += 1

    def next(self):
        step, batch = self.q.get()
        if isinstance(batch, Exception):
            raise batch
        return step, batch

    def stop(self):
        self._stop.set()
        self.thread.join(timeout=5.0)
