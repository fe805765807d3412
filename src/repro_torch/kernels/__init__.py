"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch
versions (``ref``) and wrappers that choose between them by device."""
