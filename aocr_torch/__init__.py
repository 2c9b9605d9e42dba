"""aocr_torch: the attention-OCR system in PyTorch on an NVIDIA H100.

A port of the JAX package `aocr` (which stays as the reference), slice by
slice: greedy, beam and dictionary recognition and scoring
(`aocr_torch.api.AttentionOCR`), the training step
(`aocr_torch.train_step`), the CLI trainer (`python -m
aocr_torch.train`), the server (`python -m aocr_torch.serve`), data
parallelism (`aocr_torch.parallel`) and the Torch7 checkpoint import
(`python -m aocr_torch.torch_import`).  Every TPU Pallas kernel of
`aocr` is a hand-written CUDA kernel for sm_90a (`aocr_torch/csrc`,
built at first use); on CPU tensors each runs its plain PyTorch
version.  The package keeps its own
copies of the framework-neutral modules (`config`, `vocab`,
`checkpoint`, `data`, `utils/trie`, `utils/logging_util`,
`utils/native`) and imports neither jax nor `aocr`.

Importing it switches TF32 off for cuBLAS matmuls and cuDNN convolutions
(`ops.mm.set_precision_policy`): float32 means full float32, as the
reference's Precision.HIGHEST.
"""

from aocr_torch.ops.mm import set_precision_policy

set_precision_policy()
