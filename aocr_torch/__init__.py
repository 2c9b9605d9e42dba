"""aocr_torch: the attention-OCR system in PyTorch on an NVIDIA H100.

A port of the JAX package `aocr` (which stays as the reference), slice by
slice; this slice is greedy recognition (`aocr_torch.api.AttentionOCR`).
The TPU Pallas kernels on its path are hand-written CUDA kernels for
sm_90a (`aocr_torch/csrc`, built at first use); on CPU tensors each runs
its plain PyTorch version.  Framework-neutral reference modules are
imported, not copied: `aocr.config`, `aocr.vocab`, `aocr.checkpoint`.
This package never imports jax.

Importing it switches TF32 off for cuBLAS matmuls and cuDNN convolutions
(`ops.mm.set_precision_policy`): float32 means full float32, as the
reference's Precision.HIGHEST.
"""

from aocr_torch.ops.mm import set_precision_policy

set_precision_policy()
