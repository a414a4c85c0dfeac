"""Data pipeline (the port's counterpart of ``repro.data.pipeline``):
the deterministic synthetic source, a memory-mapped token-file source and
host-side prefetch.

Both sources are pure functions of the step: the synthetic sampler draws
from numpy's Philox stream exactly as the JAX package draws it, and
``TokenFile`` cuts the file as the JAX one does, so both packages see the
same batches bit for bit, and a restart resumes the same token stream.
Both lay the sequence out in the SP shard order (zigzag or contiguous).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import startrail as st


def shard_permutation(seq_len: int, sp_size: int, scheme: str
                      ) -> np.ndarray:
    """(sp_size, seq_len // sp_size): rank p's token positions, in order."""
    return np.stack([st.shard_positions(p, seq_len, sp_size, scheme).numpy()
                     for p in range(sp_size)])


class SyntheticLM:
    """Deterministic synthetic next-token data (self-supervised layout)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                 seq_scheme: str = "zigzag", sp_size: int = 1):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.scheme = seq_scheme
        self.positions = shard_permutation(shape.seq_len, sp_size,
                                           seq_scheme)
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


class TokenFile:
    """Memory-mapped packed-token file source (a flat uint16 or uint32
    ``.bin``): batch ``step`` is the ``step % num_batches``-th run of
    ``global_batch * (seq_len + 1)`` tokens, each row's tokens and labels
    its first and last ``seq_len``."""

    def __init__(self, path: str, cfg: ModelConfig, shape: ShapeConfig, *,
                 dtype=np.uint16, seq_scheme: str = "zigzag",
                 sp_size: int = 1):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.cfg = cfg
        self.shape = shape
        self.perm = shard_permutation(shape.seq_len, sp_size,
                                      seq_scheme).reshape(-1)
        self.tokens_per_batch = shape.global_batch * (shape.seq_len + 1)
        self.num_batches = len(self.data) // self.tokens_per_batch
        if self.num_batches == 0:
            raise ValueError(f"{path}: too small for one batch")

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        i = step % self.num_batches
        flat = np.asarray(self.data[i * self.tokens_per_batch:
                                    (i + 1) * self.tokens_per_batch],
                          dtype=np.int32)
        chunk = flat.reshape(self.shape.global_batch, self.shape.seq_len + 1)
        return {"tokens": np.take(chunk[:, :-1], self.perm, axis=1),
                "labels": np.take(chunk[:, 1:], self.perm, axis=1)}


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
