"""Training loop with fault tolerance (the port of ``repro.train.loop``).

Single-process loop on one device (``device="cuda"`` by default,
``"cpu"`` when asked). Fault tolerance pieces exercised here:
  * periodic async checkpoints into the chunk store (content-addressed,
    incremental): with a service-backed ``CheckpointManager`` each one
    is a publish through the SHA-256 and AES kernels,
  * crash/restart: ``resume()`` rebuilds state from the newest manifest
    through ``CheckpointManager.reader`` — a cold start through the
    service's decode backend (the fused verify+decrypt kernel on the
    card),
  * per-step failure injection hooks for the elastic-recovery tests,
  * straggler mitigation at the storage layer (constant-work erasure
    reads) — the loop itself never retries a fetch.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import global_batch
from repro_torch.models.lm import RunFlags
from repro_torch.models.registry import build_model
from repro_torch.train.checkpoint import to_device, tree_from_flat
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import (
    init_train_state,
    make_train_step,
    train_state_template,
)


@dataclass
class LoopConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 64
    ckpt_every: int = 25
    log_every: int = 10
    seed: int = 0
    opt: OptConfig = field(default_factory=OptConfig)


class Trainer:
    def __init__(self, cfg: ModelConfig, loop: LoopConfig, ckpt_mgr=None,
                 flags=None, device="cuda"):
        self.cfg = cfg
        self.loop = loop
        self.device = resolve_device(device)
        self.model = build_model(cfg, flags or RunFlags(), device=device)
        self.ckpt = ckpt_mgr
        self.step_fn = make_train_step(self.model, loop.opt)
        self.state = None
        self.step = 0
        self.history: list[dict] = []
        self.failure_hook = None      # callable(step) -> bool (crash?)

    def init(self):
        self.state = init_train_state(self.model, self.loop.seed,
                                      self.loop.opt)
        self.step = 0
        return self

    def resume(self):
        """Restart path: newest checkpoint -> state."""
        assert self.ckpt is not None
        recs = self.ckpt.discover()
        if not recs:
            return self.init()
        rec = recs[-1]
        template = train_state_template(self.cfg, self.loop.opt)
        reader = self.ckpt.reader(rec)
        self.state = to_device(tree_from_flat(template, reader.restore_tree()),
                               self.device)
        self.step = rec.step
        return self

    def run(self, steps: int | None = None) -> list:
        steps = steps if steps is not None else self.loop.steps
        target = self.step + steps
        while self.step < target:
            if self.failure_hook is not None and self.failure_hook(self.step):
                raise WorkerFailure(self.step)
            batch = global_batch(self.cfg, self.step, self.loop.batch,
                                 self.loop.seq, seed=self.loop.seed)
            t0 = time.time()
            self.state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])
            self.step += 1
            if self.step % self.loop.log_every == 0 or self.step == target:
                self.history.append({"step": self.step, "loss": loss,
                                     "grad_norm": float(metrics["grad_norm"]),
                                     "s": time.time() - t0})
            if self.ckpt is not None and self.step % self.loop.ckpt_every == 0:
                self.ckpt.save(self.step, self.state)
        if self.ckpt is not None:
            self.ckpt.wait()
        return self.history


class WorkerFailure(Exception):
    def __init__(self, step):
        self.step = step
        super().__init__(f"worker failed at step {step}")
