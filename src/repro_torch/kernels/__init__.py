"""Count-table kernels: CUDA sources in ``csrc/``, wrappers, plain versions."""
