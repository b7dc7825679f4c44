"""``build_model(cfg, flags)``: the model object of a config (the port
of ``repro.models.registry``). The port serves the dense family; the
other families (MoE, Mamba, xLSTM, encoder-decoder, VLM) are ROADMAP.md
queue 1, item 4 ("The other model families")."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import DecoderLM, RunFlags


def build_model(cfg: ModelConfig, flags: RunFlags = RunFlags(),
                device="cuda") -> DecoderLM:
    """A ``DecoderLM`` on `device` for a dense config; raises
    ``NotImplementedError`` for any other family."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported: "
            "ROADMAP.md queue 1, item 4 (the other model families)")
    return DecoderLM(cfg, flags, device=device)
