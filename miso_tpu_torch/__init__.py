"""miso_tpu_torch: the PyTorch / CUDA port of miso_tpu for one NVIDIA H100.

The JAX package ``miso_tpu`` stays the reference.  This package reuses its
JAX-free host code (GFF/BAM ingest, event compile, the ``.miso`` writers)
and replaces the device half: the REASSIGN sampler runs as a CUDA kernel
written by hand for ``sm_90a`` (``csrc/reassign_kernel.cu``), with a plain
PyTorch version beside it for CPU tensors.
"""
import torch

__version__ = "0.1.0"

# No contraction on the sampler path may round through TF32: it is the
# TF32 form of the bf16 matrix-unit trap in docs/VALIDATION.md (acceptance
# 0.84 -> 0.24 when a contraction lost precision).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
