from repro_torch.kernels.parity.ops import (  # noqa: F401
    parity,
    parity_fn_for_erasure,
)
