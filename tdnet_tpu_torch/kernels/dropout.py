"""Dropout with a 1 / (1 - rate) scale, its mask regenerated from a seed (K3).

The attention fc's dropout (rate 0.1, reference Training/.../td4_psp/
transformer.py:89). The CUDA kernel is ``csrc/dropout.cu``; the keep mask of
element (row, c) of the contiguous [rows, C] view is
``keep_mask(seed, rate, ...)`` of ``ops/dropout_mask.py``, so
``dropout_plain`` gives the kernel's output bit for bit. The backward applies
the same mask to the cotangent: the kernel runs again on dy with the saved
seed, as the TPU kernel's VJP does (tdnet_tpu/kernels/dropout.py:51-66).

``dropout`` takes the plain version for CPU tensors and, through an autograd
function, the kernel for CUDA tensors. A launch is one ``ctypes`` call of the C
entry point (bound once an entry, ``_function``) with the arguments
``launch_args`` gives, on the raw handle of the current stream.
``dropout.launches`` and ``dropout.backward_launches`` count the f32 kernel's
forward and backward launches, ``.bf16_launches`` and
``.bf16_backward_launches`` the bfloat16 kernel's.

It takes float32 and bfloat16 and returns x's dtype. In bfloat16 the scale is
1 / (1 - rate) rounded to bfloat16 first (1.109375 at rate 0.1), as the TPU
kernel's weak-typed Python float is (``tdnet_tpu/kernels/dropout.py:30``); the
product of two bfloat16 values is exact in f32, so the kernel and the plain
version round x * scale once, to bfloat16.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tdnet_tpu_torch.kernels.build import load_library
from tdnet_tpu_torch.kernels.device import on_device
from tdnet_tpu_torch.ops.dropout_mask import keep_mask, keep_threshold

SOURCES = ("dropout.cu",)
# the C entry point of each dtype the kernel takes
ENTRIES = {torch.float32: "tdnet_dropout", torch.bfloat16: "tdnet_dropout_bf16"}


def dropout_plain(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """where(keep, x * (1 / (1 - rate)), 0), differentiable through autograd;
    the scale in x's dtype."""
    keep = keep_mask(seed, rate, tuple(x.shape), device=x.device)
    inv_keep = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype)
    return torch.where(keep, x * inv_keep, torch.zeros((), dtype=x.dtype))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C interface's argument and result types on a loaded library."""
    for name in ENTRIES.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint,
                       ctypes.c_uint, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.tdnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (or reuse) the kernel library and declare its C interface; needs nvcc."""
    return declare(load_library("dropout", SOURCES))


@functools.cache
def _rate_args(rate: float, dtype: torch.dtype = torch.float32) -> tuple[int, float]:
    """(keep threshold, 1 / (1 - rate) rounded to ``dtype``) of a rate: the
    scale the kernel multiplies by, as ``dropout_plain`` does."""
    return keep_threshold(rate), torch.tensor(1.0 / (1.0 - rate), dtype=dtype).item()


def launch_args(n: int, dtype: torch.dtype, rate: float, seed: int) -> tuple:
    """What a launch over ``n`` elements of ``dtype`` passes: (C entry point,
    element count, the seed's low 32 bits, keep threshold, scale)."""
    if dtype not in ENTRIES:
        raise ValueError(f"the dropout kernel takes float32 or bfloat16, got {dtype}")
    return (ENTRIES[dtype], n, seed & 0xFFFFFFFF) + _rate_args(rate, dtype)


@functools.cache
def _function(entry: str):
    """The bound C function of an entry point."""
    return getattr(build(), entry)


def _launch(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """One kernel launch on the current stream of x's device, with that device
    current; raises on what it does not take."""
    if not x.is_contiguous():
        raise ValueError("the dropout kernel takes contiguous tensors")
    entry, n, seed32, threshold, inv_keep = launch_args(x.numel(), x.dtype, rate, seed)
    y = torch.empty_like(x)
    with on_device(x) as stream:
        err = _function(entry)(x.data_ptr(), y.data_ptr(), n, seed32, threshold, inv_keep,
                               stream)
    if err != 0:
        raise RuntimeError(f"dropout kernel failed: CUDA error {err}: "
                           f"{build().tdnet_cuda_error_string(err).decode()}")
    return y


class _DropoutKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate, seed):
        ctx.rate, ctx.seed = rate, seed
        y = _launch(x, rate, seed)
        if x.dtype == torch.float32:
            dropout.launches += 1
        else:
            dropout.bf16_launches += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = _launch(dy.contiguous(), ctx.rate, ctx.seed)
        if dy.dtype == torch.float32:
            dropout.backward_launches += 1
        else:
            dropout.bf16_backward_launches += 1
        return dx, None, None


def dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Bernoulli(1 - rate) dropout with a 1 / (1 - rate) scale, the mask a
    function of (seed, flat element index); differentiable."""
    if x.is_cuda:
        return _DropoutKernel.apply(x, rate, seed)
    if x.device.type == "cpu":
        return dropout_plain(x, rate, seed)
    raise ValueError(f"no kernel for device {x.device}")


dropout.launches = 0
dropout.backward_launches = 0
dropout.bf16_launches = 0
dropout.bf16_backward_launches = 0
