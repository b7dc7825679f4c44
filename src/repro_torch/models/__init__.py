from repro_torch.models.encdec import EncDecModel  # noqa: F401
from repro_torch.models.lm import DecoderLM, RunFlags, init_flat  # noqa: F401
from repro_torch.models.registry import build_model  # noqa: F401
