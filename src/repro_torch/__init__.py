"""PyTorch/CUDA port of the color-coding subgraph counter (see ``repro`` for
the JAX reference).  Submodules: ``core`` (graphs, templates, the DP
engine and estimator), ``kernels`` (hand-written Hopper kernels and their
plain versions), ``configs``, ``launch``."""
