"""Attention kernel K1 (CUDA, ``csrc/flash_fwd.cu``) with its plain PyTorch
version; ``ops`` dispatches between them by device."""
