"""Deterministic synthetic LM data (a copy of ``repro/data/pipeline.py``,
numpy only, so both packages train on the same tokens).

The stream is a fixed-seed Markov process over the vocabulary (each token
has ``branch`` successors with Zipf weights, 5% random resets), seekable
by sequence index so a resumed run neither replays nor skips data.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq: int
    global_batch: int
    micro_steps: int
    seed: int = 1234
    # Markov-chain synthetic text knobs
    branch: int = 32          # successors per state
    skew: float = 1.3         # Zipf skew of the successor distribution


class SyntheticLM:
    """Deterministic, seekable synthetic token stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._succ = rng.integers(0, cfg.vocab, (cfg.vocab, cfg.branch))
        w = 1.0 / np.arange(1, cfg.branch + 1) ** cfg.skew
        self._w = w / w.sum()

    def sequence(self, index: int) -> np.ndarray:
        """The ``index``-th sequence (stateless, so seekable)."""
        rng = np.random.default_rng((self.cfg.seed, index))
        toks = np.empty(self.cfg.seq + 1, np.int32)
        toks[0] = rng.integers(self.cfg.vocab)
        choices = rng.choice(self.cfg.branch, size=self.cfg.seq, p=self._w)
        noise = rng.random(self.cfg.seq)
        for t in range(self.cfg.seq):
            if noise[t] < 0.05:  # 5% resets keep entropy > 0
                toks[t + 1] = rng.integers(self.cfg.vocab)
            else:
                toks[t + 1] = self._succ[toks[t], choices[t]]
        return toks

    def global_step_batch(self, step: int) -> dict[str, np.ndarray]:
        """Full global batch for a step (one host)."""
        return self.host_step_batch(step, host_index=0, host_count=1)

    def host_step_batch(self, step: int, host_index: int, host_count: int):
        """This host's slice: [micro, local_b, seq] per field."""
        cfg = self.cfg
        if cfg.global_batch % (cfg.micro_steps * host_count):
            raise ValueError("global batch must divide by micro_steps*hosts")
        per_micro = cfg.global_batch // cfg.micro_steps
        local_b = per_micro // host_count
        toks = np.empty((cfg.micro_steps, local_b, cfg.seq + 1), np.int32)
        for m in range(cfg.micro_steps):
            for i in range(local_b):
                seq_index = (step * cfg.global_batch + m * per_micro
                             + host_index * local_b + i)
                toks[m, i] = self.sequence(seq_index)
        return {
            "tokens": toks[:, :, :-1],
            "targets": toks[:, :, 1:],
            "mask": np.ones((cfg.micro_steps, local_b, cfg.seq), np.float32),
        }


class PrefetchLoader:
    """Host batches made ahead on a background thread, ``depth`` deep.
    Iterating yields ``(step, batch)``; :meth:`close` stops the thread."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 host_index: int = 0, host_count: int = 1, depth: int = 2):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._host = (host_index, host_count)
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.host_step_batch(step, *self._host)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            yield self._q.get()

    def close(self, timeout: float = 10.0):
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("PrefetchLoader: the producer thread did not stop")
