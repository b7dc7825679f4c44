from repro_torch.models.lm import DecoderLM, RunFlags, init_flat  # noqa: F401
