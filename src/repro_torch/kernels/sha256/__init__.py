from repro_torch.kernels.sha256.ops import sha256_lanes, sha256_many  # noqa: F401
