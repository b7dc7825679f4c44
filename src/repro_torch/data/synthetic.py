"""Deterministic synthetic LM data pipeline (the port of
``repro.data.synthetic``: numpy on the host, the same draws).

Tokens are a seeded function of (step, position) so every data-parallel
shard, restart, and elastic re-scale sees exactly the same global batch —
which is what makes checkpoint-resume bitwise reproducible in tests.
A background prefetch thread overlaps host data generation with device
compute (the real-input-pipeline shape, minus the filesystem). A VLM
batch adds ``patches`` (B, num_patches, D) and holds seq - num_patches
tokens; an encoder-decoder batch adds ``frames`` (B, seq, D); both
carry no planted structure, as the JAX package's do.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.configs.base import ModelConfig


def global_batch(cfg: ModelConfig, step: int, batch: int, seq: int,
                 seed: int = 1234) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    if cfg.family == "vlm":
        P = cfg.num_patches
        toks = rng.integers(0, cfg.vocab_size, (batch, seq - P + 1),
                            dtype=np.int32)
        patches = rng.standard_normal((batch, P, cfg.d_model))
        return {"tokens": toks[:, :-1],
                "patches": patches.astype(np.float32) * 0.02,
                "labels": toks[:, 1:]}
    if cfg.is_encdec:
        toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1),
                            dtype=np.int32)
        frames = rng.standard_normal((batch, seq, cfg.d_model))
        return {"frames": frames.astype(np.float32) * 0.1,
                "tokens": toks[:, :-1], "labels": toks[:, 1:]}
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1), dtype=np.int32)
    # plant learnable structure: token t+1 correlates with token t
    toks[:, 1:] = (toks[:, :-1] * 31
                   + rng.integers(0, 7, (batch, seq))) % cfg.vocab_size
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    def __init__(self, make_batch, start_step: int = 0, depth: int = 2):
        self.make_batch = make_batch
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = False
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        s = self.step
        while not self._stop:
            try:
                self.q.put((s, self.make_batch(s)), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def next(self):
        return self.q.get()

    def stop(self):
        self._stop = True
