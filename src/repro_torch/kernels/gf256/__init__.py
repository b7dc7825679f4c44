from repro_torch.kernels.gf256.ops import (  # noqa: F401
    gf_matmul,
    rs_matmul_fn,
    rs_parity_fn,
)
