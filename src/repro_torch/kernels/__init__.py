"""Attention kernels K1 (CUDA, ``csrc/flash_fwd.cu``), K2 and K3 (CUDA,
``csrc/flash_bwd.cu``) with their plain PyTorch versions; ``ops``
dispatches between them by device."""
