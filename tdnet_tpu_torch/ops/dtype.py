"""The compute type of the plain ops: float32, or the input's type where it
is wider (float64, which the parity tests use as their exact reference); and
``no_tf32``, the precision scope of the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


@contextlib.contextmanager
def no_tf32():
    """f32 convolutions and matrix products without TF32 inside the block:
    cuDNN's ``allow_tf32`` off and the f32 matmul precision ``"highest"``, the
    caller's settings restored after. The JAX package's f32 recipe has no TF32
    mode; torch's default lets cuDNN take TF32, so the runtime and the trainer
    run their work in this scope."""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(matmul)
