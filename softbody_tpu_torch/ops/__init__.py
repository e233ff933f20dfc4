"""Per-particle math, 3x3 algebra and the pair kernels."""
