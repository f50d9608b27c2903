"""PyTorch/CUDA port of feature_level_style_transfer_for_tsc_tpu.

A second package beside the JAX one: it imports torch and numpy, never jax
and nothing of the JAX package.  Module names mirror the JAX package's, and
public functions keep its layouts: activations (B, T, C), OS conv weights
(K, C_in, C_out), BatchNorm statistics (C,).  Every Pallas kernel of the
JAX package on a ported path is a hand-written CUDA kernel here
(``ops/csrc``), launched for CUDA tensors; CPU tensors take the plain
PyTorch version beside each kernel.
"""
