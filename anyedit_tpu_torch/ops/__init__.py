"""Ops of the port: attention (K1), GroupNorm (K2), resize. The CUDA
kernels build from `anyedit_tpu_torch/csrc` at first use (`ops/_build.py`)."""
