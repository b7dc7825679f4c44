"""Batched serving engine (the port of ``repro.serve.engine``): slot
batching over the model's cached ``decode_step``, greedy sampling,
prompts prefilled by decoding one token per step.

The decode state is the model's tree of groups and sublayers (KV
caches, Mamba and xLSTM windows and cell states; an encoder-decoder's
self-attention caches and cross k/v), which ``decode_step`` returns and
the engine keeps. As in the JAX package, admitting a request to a
freed slot resets its position but not its state: a Mamba or xLSTM
sublayer starts from the previous occupant's state (ROADMAP.md §3),
while attention masks the old cache rows by position. The engine takes
tokens only: a VLM decodes without patches, and an encoder-decoder
against the zero cross k/v of ``init_decode_state`` (no frames), as
the JAX engine does."""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.telemetry import COUNTERS


@dataclass
class Request:
    rid: int
    prompt: list
    max_new: int = 16
    out: list = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model, *, max_batch: int = 4, max_len: int = 128):
        self.model = model
        self.B = max_batch
        self.max_len = max_len
        self.state = model.init_decode_state(max_batch, max_len)
        self.pos = np.zeros(max_batch, np.int64)
        self.slot_req: list = [None] * max_batch
        self.queue: list = []
        self.tokens = np.zeros(max_batch, np.int64)
        self.steps = 0

    def submit(self, req: Request):
        self.queue.append(req)
        COUNTERS.inc("serve.requests")

    def _admit(self):
        for slot in range(self.B):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[slot] = req
                self.pos[slot] = 0
                req._feed = list(req.prompt)
                self.tokens[slot] = req._feed.pop(0)

    def step(self) -> bool:
        self._admit()
        active = [s for s in range(self.B) if self.slot_req[s] is not None]
        if not active:
            return False
        logits, self.state = self.model.decode_step(
            self.state, torch.from_numpy(self.tokens.copy()),
            torch.from_numpy(self.pos.copy()))
        # argmax on the host, float32 values: numpy's first-index ties
        vocab = self.model.cfg.vocab_size
        logits = logits[:, :vocab].float().cpu().numpy()
        self.steps += 1
        for s in active:
            req = self.slot_req[s]
            self.pos[s] += 1
            if req._feed:                        # still consuming the prompt
                self.tokens[s] = req._feed.pop(0)
                continue
            nxt = int(np.argmax(logits[s]))
            req.out.append(nxt)
            self.tokens[s] = nxt
            if len(req.out) >= req.max_new or self.pos[s] >= self.max_len - 1:
                req.done = True
                self.slot_req[s] = None
                COUNTERS.inc("serve.completed")
        return True

    def run_until_drained(self, max_steps: int = 10_000) -> dict:
        t0 = time.perf_counter()
        while (self.queue or any(self.slot_req)) and self.steps < max_steps:
            self.step()
        return {"steps": self.steps, "seconds": time.perf_counter() - t0}
