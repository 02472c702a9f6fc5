"""PyTorch/CUDA port of ``tartangan_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here
computes the same function on the same parameter tree, and the tests hold
each against its JAX counterpart. The Pallas kernels of the reference become
hand-written CUDA kernels under ``csrc/`` (built at first use by
``ops/build.py``); each has a plain PyTorch version beside it, which is what
runs for tensors on the CPU.

This package imports torch, numpy and the standard library only — never
jax, flax or ``tartangan_tpu``.
"""
