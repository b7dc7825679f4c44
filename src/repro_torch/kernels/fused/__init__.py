from repro_torch.kernels.fused.ops import (  # noqa: F401
    fused_verify_decrypt,
    fused_verify_decrypt_lanes,
)
