"""PyTorch/CUDA port of anyedit_tpu for NVIDIA Hopper.

The JAX package `anyedit_tpu` is the reference; this package keeps its
module layout and names. It imports torch and never jax, flax or
anyedit_tpu. The hand-written CUDA kernels live in `csrc/` and build with
nvcc at first use.
"""
