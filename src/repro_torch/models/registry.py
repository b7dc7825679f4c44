"""``build_model(cfg, flags)``: the model object of a config (the port
of ``repro.models.registry``). The port serves the dense, MoE and hybrid
(Jamba) families; for xLSTM, encoder-decoder and VLM configs
``models.lm.layout`` raises ``NotImplementedError`` naming ROADMAP.md
queue 1, item 4b."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import DecoderLM, RunFlags


def build_model(cfg: ModelConfig, flags: RunFlags = RunFlags(),
                device="cuda") -> DecoderLM:
    """A ``DecoderLM`` of `cfg` on `device`."""
    return DecoderLM(cfg, flags, device=device)
