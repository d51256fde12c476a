"""Hand-written CUDA kernels (``lut_cascade``, ``neuralut_mlp``), their
plain PyTorch versions (``ref``) and the build that compiles them."""
