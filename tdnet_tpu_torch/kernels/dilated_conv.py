"""Stride-1 dilated 3x3 convolution with its gradient (K5).

The residual blocks' 3x3 convs with dilation >= 4 in training, when the
context asks for them (``Ctx(conv_wgrad="kernel")``; the JAX package's
``conv_wgrad="pallas"``, ``tdnet_tpu/kernels/dilated_conv.py``). The CUDA
kernel is ``csrc/dilated_conv.cu``; ``dilated_conv_plain`` is its plain
PyTorch version, the same sum of 9 shifted per-tap products as the TPU
kernel's ``_dil_kernel``.

``conv2d_dil`` is one ``torch.autograd.Function`` on both devices: its
forward is the kernel (CUDA tensors) or the plain version (CPU tensors); its
backward computes dx with the same forward on dy, the spatially flipped,
IO-swapped weights and padding d*(k-1) - p (``_pd_bwd``), and dW with
``ops.conv.tap_wgrad``. ``conv2d_dil.launches`` and ``.backward_launches``
count the kernel's forward and dgrad launches, where they launch. f32 only.
"""

from __future__ import annotations

import ctypes

import torch

from tdnet_tpu_torch.kernels.build import load_library
from tdnet_tpu_torch.ops.conv import tap_wgrad

SOURCES = ("dilated_conv.cu",)
K = 3          # the kernel's taps per axis
CI_STEP = 8    # input channels per K step of the kernel


def dilated_conv_plain(x: torch.Tensor, w: torch.Tensor, padding: int,
                       dilation: int) -> torch.Tensor:
    """x [n, ci, H, W], w [co, ci, 3, 3] -> [n, co, H + 2p - 2d, W + 2p - 2d]:
    the sum over the 9 taps of the shifted input times that tap's [co, ci]."""
    d = dilation
    ho = x.shape[2] + 2 * padding - d * (K - 1)
    wo = x.shape[3] + 2 * padding - d * (K - 1)
    xp = torch.nn.functional.pad(x, (padding,) * 4)
    out = None
    for i in range(K):
        for j in range(K):
            xs = xp[:, :, i * d:i * d + ho, j * d:j * d + wo]
            t = torch.einsum("oc,nchw->nohw", w[:, :, i, j], xs)
            out = t if out is None else out + t
    return out


def build() -> ctypes.CDLL:
    """Compile (or reuse) the kernel library and declare its C interface; needs nvcc."""
    lib = load_library("dilated_conv", SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tdnet_dilated_conv.argtypes = [p, p, p] + [i] * 7 + [p]
    lib.tdnet_dilated_conv.restype = ctypes.c_int
    lib.tdnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, w: torch.Tensor, padding: int, dilation: int) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[2:]) != (K, K) or w.shape[1] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)}: want [n, ci, H, W] "
                         f"and [co, ci, {K}, {K}]")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"the dilated conv takes float32, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    if min(x.shape[2], x.shape[3]) + 2 * padding - dilation * (K - 1) < 1:
        raise ValueError(f"empty output: {tuple(x.shape)}, padding {padding}, dilation {dilation}")
    if x.is_cuda and (x.shape[1] % CI_STEP or w.shape[0] % CI_STEP):
        raise ValueError(f"the kernel takes ci and co divisible by {CI_STEP} (the forward's "
                         f"and the dgrad's input channels), got {x.shape[1]} -> {w.shape[0]}")


def _forward(x: torch.Tensor, w: torch.Tensor, padding: int, dilation: int,
             counter: str) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors; a launch
    adds one to ``conv2d_dil.<counter>``."""
    if x.device.type == "cpu":
        return dilated_conv_plain(x, w, padding, dilation)
    n, ci, h, wd = x.shape
    co = w.shape[0]
    x = x.contiguous()
    w9 = w.permute(2, 3, 1, 0).reshape(K * K, ci, co).contiguous()
    d = dilation
    y = torch.empty((n, co, h + 2 * padding - 2 * d, wd + 2 * padding - 2 * d),
                    dtype=x.dtype, device=x.device)
    lib = build()
    err = lib.tdnet_dilated_conv(x.data_ptr(), w9.data_ptr(), y.data_ptr(), n, ci, co, h, wd,
                                 padding, d, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dilated conv kernel failed: CUDA error {err}: "
                           f"{lib.tdnet_cuda_error_string(err).decode()}")
    setattr(conv2d_dil, counter, getattr(conv2d_dil, counter) + 1)
    return y


class _DilatedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, padding, dilation):
        y = _forward(x, w, padding, dilation, "launches")
        ctx.save_for_backward(x, w)
        ctx.padding, ctx.dilation = padding, dilation
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        p, d = ctx.padding, ctx.dilation
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the dgrad is the same conv of dy with the flipped, IO-swapped kernel, laid
            # out by copies: read in place, transposed, by the kernel, the weights made
            # the train step's dgrad launches 14% longer (PERF.md)
            dx = _forward(dy, torch.flip(w, (2, 3)).transpose(0, 1), d * (K - 1) - p, d,
                          "backward_launches")
        if ctx.needs_input_grad[1]:
            dw = tap_wgrad(x, dy, p, d, K)
        return dx, dw, None, None


def conv2d_dil(x: torch.Tensor, w: torch.Tensor, padding: int, dilation: int) -> torch.Tensor:
    """Differentiable stride-1 dilated 3x3 conv, NCHW input, OIHW weights, f32."""
    _check(x, w, padding, dilation)
    return _DilatedConv.apply(x, w, padding, dilation)


conv2d_dil.launches = 0
conv2d_dil.backward_launches = 0
