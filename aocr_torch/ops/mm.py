"""Matmul precision policy (counterpart of aocr/ops/mm.py).

float32 operands multiply in full float32: TF32 is switched off for cuBLAS
matmuls and for cuDNN convolutions (`set_precision_policy`, applied when
`aocr_torch` is imported).  PyTorch leaves `torch.backends.cudnn.allow_tf32`
True by default, which would round the conv inputs of convs 2-7 to a 10-bit
mantissa; the JAX package asks for `Precision.HIGHEST` there.

bfloat16 operands multiply exactly and accumulate in float32, returning
float32 (JAX's `preferred_element_type=float32`).  A bf16 x bf16 product is
exact in float32, so the operands are widened and multiplied in float32; a
plain bf16 `torch.matmul` would round its output to bf16 before the bias
add, which the reference never does.
"""

from __future__ import annotations

import torch


def set_precision_policy() -> None:
    """No TF32 anywhere: float32 means float32, as Precision.HIGHEST."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 accumulation, returned in float32."""
    return torch.matmul(a.float(), b.float())


def outer_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over all leading axes of a[..., :, None] * b[..., None, :]: a
    weight gradient batched over a whole sequence, float32 accumulation
    (the reference's einsum("tbd,tbg->dg"))."""
    return matmul(a.reshape(-1, a.shape[-1]).t(), b.reshape(-1, b.shape[-1]))
