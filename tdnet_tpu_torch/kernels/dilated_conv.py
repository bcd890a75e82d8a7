"""Stride-1 dilated 3x3 convolution with its gradient (K5), f32 or bf16.

The residual blocks' 3x3 convs with dilation >= 4 in training, when the
context asks for them (``Ctx(conv_wgrad="kernel")``; the JAX package's
``conv_wgrad="pallas"``, ``tdnet_tpu/kernels/dilated_conv.py``), in the f32
recipe and in the bf16 mixed-precision one. The CUDA kernels are
``csrc/dilated_conv.cu``: an implicit GEMM on the tensor cores over a
padded-width row index, after two prep passes that lay out x and the weights
(f32: ``mma.sync`` in 3xTF32, the prep passes split both into TF32 hi and lo;
bf16: ``wgmma`` fed by TMA, bf16 products summed in f32 chains of one tap and
64 channels, tap-major as the f32 kernel's). ``conv_plan`` sizes the scratch;
the C side checks it against its tiles and sizes the grid.
``dilated_conv_plain`` is its plain PyTorch version with the TPU kernel's
rounding (``_dil_kernel``): the sum of 9 shifted per-tap products taken in
f32 and rounded once to the input's dtype.

``conv2d_dil`` is one ``torch.autograd.Function`` on both devices: its
forward is the kernel (CUDA tensors) or the plain version (CPU tensors); its
backward computes dx with the same forward on dy, the spatially flipped,
IO-swapped weights (the kernel's weight pass flips and swaps them) and
padding d*(k-1) - p (``_pd_bwd``), and dW with ``ops.conv.tap_wgrad``.
``conv2d_dil.launches`` and ``.backward_launches`` count the f32 kernel's
forward and dgrad launches, ``.bf16_launches`` and
``.bf16_backward_launches`` the bf16 kernel's. x and w share one dtype,
float32 or bfloat16; the output and dx take it. The bf16 kernel's consumer
warpgroups report a barrier they gave up on in the error word that K5 shares
with K1 (``kernels/fault.py``): its callers read it with ``check_fault``
where they synchronize.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from tdnet_tpu_torch.kernels.build import load_library
from tdnet_tpu_torch.kernels.device import on_device
from tdnet_tpu_torch.kernels.fault import fault_word
from tdnet_tpu_torch.ops.conv import tap_wgrad
from tdnet_tpu_torch.ops.dtype import at_least_f32

SOURCES = ("dilated_conv.cu",)
K = 3          # the kernel's taps per axis
BM = 128       # GEMM rows (padded-width output pixels) a block of the kernel owns
BN = 128       # output channels a block owns
BK = 32        # f32 input channels a stage: 4 k-steps of mma m16n8k8, one chain
BK_BF16 = 64   # bf16 input channels a stage: 4 k-steps of wgmma k16, one chain
DTYPES = {torch.float32: BK, torch.bfloat16: BK_BF16}   # the kernel's dtypes -> their BK


def dilated_conv_plain(x: torch.Tensor, w: torch.Tensor, padding: int,
                       dilation: int) -> torch.Tensor:
    """x [n, ci, H, W], w [co, ci, 3, 3] -> [n, co, H + 2p - 2d, W + 2p - 2d]:
    the sum over the 9 taps of the shifted input times that tap's [co, ci],
    taken in f32 (float64 stays float64) and rounded once to x's dtype, as the
    TPU kernel sums its taps (``preferred_element_type=f32``, then ``astype``).
    bf16 products are exact in f32."""
    d = dilation
    ho = x.shape[2] + 2 * padding - d * (K - 1)
    wo = x.shape[3] + 2 * padding - d * (K - 1)
    xp = at_least_f32(torch.nn.functional.pad(x, (padding,) * 4))
    w = at_least_f32(w)
    out = None
    for i in range(K):
        for j in range(K):
            xs = xp[:, :, i * d:i * d + ho, j * d:j * d + wo]
            t = torch.einsum("oc,nchw->nohw", w[:, :, i, j], xs)
            out = t if out is None else out + t
    return out.to(x.dtype)


def dgrad_weights(w: torch.Tensor) -> torch.Tensor:
    """[co, ci, 3, 3] -> the dgrad's [ci, co, 3, 3]: flipped in space, IO-swapped."""
    return torch.flip(w, (2, 3)).transpose(0, 1)


@dataclass(frozen=True)
class ConvPlan:
    """The scratch of one kernel call: image [n, cin, h, w] -> [n, cout, ho, wo].

    Output pixel (r, c) is GEMM row r * wp + c for c over the whole padded
    width ``wp``, and tap (i, j) reads the padded input's rows shifted by
    i * dil * wp + j * dil. The padded input has ``hr`` rows of ``wp`` pixels
    (the image's h + 2 pad and zero rows below, for the last row tile's
    reads) and ``kp`` channels; the weights are ``np_`` x ``kp`` a tap."""
    wp: int
    ho: int
    wo: int
    hr: int
    kp: int
    np_: int


@functools.cache
def conv_plan(cin: int, cout: int, h: int, w: int, pad: int, dil: int,
              dtype: torch.dtype = torch.float32) -> ConvPlan:
    """The scratch sizes of one kernel call in ``dtype`` (``tdnet_dilated_conv``,
    ``tdnet_dilated_conv_bf16``): channels rounded up to its stage's BK."""
    hp, wp = h + 2 * pad, w + 2 * pad
    ho, wo = hp - dil * (K - 1), wp - dil * (K - 1)
    if min(ho, wo) < 1:
        raise ValueError(f"empty output: {h}x{w}, padding {pad}, dilation {dil}")
    # the last row tile of BM GEMM rows reads up to its last row + the last tap's offset
    reach = -(-ho * wp // BM) * BM + (K - 1) * dil * (wp + 1)
    bk = DTYPES[dtype]
    return ConvPlan(wp=wp, ho=ho, wo=wo, hr=-(-reach // wp), kp=-(-cin // bk) * bk,
                    np_=-(-cout // BN) * BN)


def library_name(defines: tuple[str, ...] = ()) -> str:
    return "dilated_conv" + "".join(f"-{d}" for d in defines)


@functools.lru_cache(maxsize=None)
def build(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile (or reuse) the kernel library and declare its C interface; needs nvcc.
    ``defines``: a debug build's ``-D`` flags (``chip_smoke.py``'s fault check)."""
    lib = load_library(library_name(defines), SOURCES, defines)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tdnet_dilated_conv.argtypes = [p] * 7 + [i] * 11 + [p]
    lib.tdnet_dilated_conv.restype = ctypes.c_int
    lib.tdnet_dilated_conv_bf16.argtypes = [p] * 6 + [i] * 11 + [p]
    lib.tdnet_dilated_conv_bf16.restype = ctypes.c_int
    lib.tdnet_dilated_conv_bf16_attributes.argtypes = [ctypes.POINTER(i)] * 2
    lib.tdnet_dilated_conv_bf16_attributes.restype = ctypes.c_int
    lib.tdnet_cuda_error_string.argtypes = [i]
    lib.tdnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"dilated conv kernel failed: CUDA error {err}: "
                           f"{lib.tdnet_cuda_error_string(err).decode()}")


def bf16_attributes() -> dict:
    """The bf16 main kernel's registers a thread at launch (its consumers take
    more by ``setmaxnreg``) and local memory a thread in bytes (spills)."""
    lib = build()
    regs, local = ctypes.c_int(), ctypes.c_int()
    _raise_on(lib, lib.tdnet_dilated_conv_bf16_attributes(ctypes.byref(regs),
                                                          ctypes.byref(local)))
    return {"registers": regs.value, "local_bytes": local.value}


def _check(x: torch.Tensor, w: torch.Tensor, padding: int, dilation: int) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[2:]) != (K, K) or w.shape[1] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)}: want [n, ci, H, W] "
                         f"and [co, ci, {K}, {K}]")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"the dilated conv takes x and w both float32 or both bfloat16, got "
                         f"{x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    if min(x.shape[2], x.shape[3]) + 2 * padding - dilation * (K - 1) < 1:
        raise ValueError(f"empty output: {tuple(x.shape)}, padding {padding}, dilation {dilation}")


def launch(x: torch.Tensor, w: torch.Tensor, padding: int, dilation: int, flip: bool = False,
           lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """The kernel's conv of CUDA tensors x and w ([cout, cin, 3, 3]) or, with
    ``flip``, of x and ``dgrad_weights(w)`` (w the forward's [cin, cout, 3, 3]),
    from ``lib`` (default ``build()``); counts no launch."""
    n, cin, h, wd = x.shape
    cout = w.shape[0] if not flip else w.shape[1]
    plan = conv_plan(cin, cout, h, wd, padding, dilation, x.dtype)
    x, w = x.contiguous(), w.contiguous()
    scratch = lambda *shape: torch.empty(shape, dtype=x.dtype, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    parts = 1 if bf16 else 2   # f32: the hi and lo halves of each operand
    xs = [scratch(n, plan.hr * plan.wp, plan.kp) for _ in range(parts)]
    ws = [scratch(K * K, plan.np_, plan.kp) for _ in range(parts)]
    y = scratch(n, cout, plan.ho, plan.wo)
    lib = lib or build()
    with on_device(x) as stream:
        if bf16:
            err = lib.tdnet_dilated_conv_bf16(
                x.data_ptr(), w.data_ptr(), xs[0].data_ptr(), ws[0].data_ptr(), y.data_ptr(),
                fault_word(x.device).data_ptr(), n, cin, cout, h, wd, padding, dilation,
                int(flip), plan.hr, plan.kp, plan.np_, stream)
        else:
            err = lib.tdnet_dilated_conv(
                x.data_ptr(), w.data_ptr(), *(t.data_ptr() for t in xs + ws), y.data_ptr(), n,
                cin, cout, h, wd, padding, dilation, int(flip), plan.hr, plan.kp, plan.np_,
                stream)
    _raise_on(lib, err)
    return y


def _forward(x: torch.Tensor, w: torch.Tensor, padding: int, dilation: int, counter: str,
             flip: bool = False) -> torch.Tensor:
    """The conv of x with w ([cout, cin, 3, 3]) or, with ``flip``, with
    ``dgrad_weights(w)`` (w the forward's [cin, cout, 3, 3]): the kernel on
    CUDA tensors, the plain version on CPU tensors; a launch adds one to
    ``conv2d_dil.<counter>`` (f32) or ``conv2d_dil.bf16_<counter>`` (bf16)."""
    if x.device.type == "cpu":
        return dilated_conv_plain(x, dgrad_weights(w) if flip else w, padding, dilation)
    y = launch(x, w, padding, dilation, flip)
    counter = f"bf16_{counter}" if x.dtype == torch.bfloat16 else counter
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
            # the same conv of dy with the flipped, IO-swapped kernel: the kernel's weight
            # pass reads w as it is and writes the flipped layout
            dx = _forward(dy, w, d * (K - 1) - p, d, "backward_launches", flip=True)
        if ctx.needs_input_grad[1]:
            dw = tap_wgrad(x, dy, p, d, K)
        return dx, dw, None, None


def conv2d_dil(x: torch.Tensor, w: torch.Tensor, padding: int, dilation: int) -> torch.Tensor:
    """Differentiable stride-1 dilated 3x3 conv, NCHW input, OIHW weights, x and
    w both float32 or both bfloat16."""
    _check(x, w, padding, dilation)
    return _DilatedConv.apply(x, w, padding, dilation)


conv2d_dil.launches = 0
conv2d_dil.backward_launches = 0
conv2d_dil.bf16_launches = 0
conv2d_dil.bf16_backward_launches = 0
