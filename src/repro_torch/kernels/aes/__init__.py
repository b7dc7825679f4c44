from repro_torch.kernels.aes.ops import aes_encrypt_blocks, encrypt_many  # noqa: F401
