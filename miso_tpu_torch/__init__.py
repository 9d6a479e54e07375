"""miso_tpu_torch: the PyTorch / CUDA port of miso_tpu for one NVIDIA H100.

The JAX package ``miso_tpu`` stays the reference; this package imports
nothing of it.  Its host half (``core/``, ``io/``, ``native/``,
``stats/intervals.py``: GFF/BAM ingest, event compile, the ``.miso``
writers) is a copy of the reference's modules of the same names, held to
them by tests/test_torch_host_copy.py.  Its device half is its own: the
REASSIGN and MARGINAL/CLASSES samplers run as CUDA kernels written by
hand for ``sm_90a`` (``csrc/``), each with a plain PyTorch version beside
it for CPU tensors.
"""
import torch

__version__ = "0.1.0"

# No contraction on the sampler path may round through TF32: it is the
# TF32 form of the bf16 matrix-unit trap in docs/VALIDATION.md (acceptance
# 0.84 -> 0.24 when a contraction lost precision).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
