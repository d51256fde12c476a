"""PyTorch and CUDA port of the NeuraLUT training and serving paths.

The package mirrors the layout of the JAX package ``repro`` module for
module (``repro_torch.core.quant`` <-> ``repro.core.quant``, ...) and
imports only ``torch``, numpy and the standard library.  Entry points
run on the CUDA device unless the caller passes ``device="cpu"``; the
hand-written kernels (``kernels/lut_cascade``, ``kernels/neuralut_mlp``,
``kernels/neuralut_grad``) launch on CUDA tensors and fall to their
plain PyTorch versions only for tensors that lie on the CPU.
"""
