"""``build_model(cfg, flags)``: the model object of a config (the port
of ``repro.models.registry``): an ``EncDecModel`` for an
encoder-decoder config, else a ``DecoderLM``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.lm import DecoderLM, RunFlags


def build_model(cfg: ModelConfig, flags: RunFlags = RunFlags(),
                device="cuda"):
    """A ``DecoderLM`` or ``EncDecModel`` of `cfg` on `device`."""
    if cfg.is_encdec:
        return EncDecModel(cfg, flags, device=device)
    return DecoderLM(cfg, flags, device=device)
