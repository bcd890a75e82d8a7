"""The dilated-conv kernel's function (K5) in bf16 against the JAX package, on the CPU.

``conv2d_dil`` on bf16 CPU tensors runs the plain version in the forward and
in the dgrad (a conv of dy with the flipped, IO-swapped kernel) and
``tap_wgrad`` for dW; the JAX side runs ``conv2d_pallas_dil`` and its VJP on
bf16 arrays with the Pallas kernel in interpret mode. Both sum every tap's
bf16 products in f32 and round once to bf16 (the products are exact in f32,
and at these sizes the f32 sums' orders round to the same bf16 value), so y,
dx and dW are held bitwise. The kernel itself is held against the plain
version on the card (``chip_smoke.py`` phase 13b).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdnet_tpu.kernels import dilated_conv as jdc
from tdnet_tpu_torch.kernels.dilated_conv import (K, conv2d_dil, conv_plan, dgrad_weights,
                                                  dilated_conv_plain)
from tests.test_torch_dilated_conv import CASES, _conv_data, interpret, oihw  # noqa: F401
from tests.test_torch_modules import nchw, nhwc

BF16_CASES = CASES + [(16, 16)]   # (dilation, padding); layer4's third conv has d = p = 16


def _bits(a) -> np.ndarray:
    """A bf16 array or tensor as its float32 values (exact)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("d,p", BF16_CASES)
def test_conv2d_dil_bf16_matches_jax_vjp(d, p, interpret):
    rng, x, w = _conv_data(d + p)
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    y, vjp = jax.vjp(lambda a, b: jdc.conv2d_pallas_dil(a, b, p, d), xj, wj)
    dy = rng.randn(*y.shape).astype(np.float32)
    dx, dw = vjp(jnp.asarray(dy, jnp.bfloat16))
    assert y.dtype == dx.dtype == dw.dtype == jnp.bfloat16

    tx = nchw(x).bfloat16().requires_grad_(True)
    tw = oihw(w).bfloat16().requires_grad_(True)
    got = conv2d_dil(tx, tw, p, d)
    got.backward(nchw(dy).bfloat16())
    assert got.dtype == tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(nhwc(got.float()), _bits(y))
    np.testing.assert_array_equal(nhwc(tx.grad.float()), _bits(dx))
    np.testing.assert_array_equal(tw.grad.float().permute(2, 3, 1, 0).numpy(), _bits(dw))
    assert conv2d_dil.bf16_launches == 0 and conv2d_dil.bf16_backward_launches == 0


def _parent_plain(x, w, padding, dilation):
    """The plain version before it summed in f32: the per-tap products added in
    x's dtype."""
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


@pytest.mark.parametrize("d,p", BF16_CASES)
def test_f32_plain_output_is_the_parents(d, p):
    torch.manual_seed(d + p)
    x, w = torch.randn(2, 16, 13, 21), torch.randn(24, 16, 3, 3) / 12
    got = dilated_conv_plain(x, w, p, d)
    assert got.dtype == torch.float32 and torch.equal(got, _parent_plain(x, w, p, d))
    dy = torch.randn_like(got)
    assert torch.equal(dilated_conv_plain(dy, dgrad_weights(w), 2 * d - p, d),
                       _parent_plain(dy, dgrad_weights(w), 2 * d - p, d))


def test_bf16_plain_rounds_once():
    """The bf16 plain version is the f32 sum of the bf16 values, rounded once;
    adding the taps in bf16 would round 9 times."""
    torch.manual_seed(3)
    x, w = torch.randn(1, 16, 13, 21).bfloat16(), (torch.randn(32, 16, 3, 3) / 12).bfloat16()
    got = dilated_conv_plain(x, w, 4, 4)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, _parent_plain(x.float(), w.float(), 4, 4).bfloat16())


def test_bf16_plan_rounds_channels_to_its_stage():
    """bf16 stages take 64 channels (128 bytes, as f32's 32): the C side's
    ``Kp == ceil(cin, BK)`` check."""
    assert conv_plan(16, 32, 13, 21, 4, 4, torch.bfloat16).kp == 64
    assert conv_plan(16, 32, 13, 21, 4, 4).kp == 32
    assert conv_plan(512, 512, 97, 193, 16, 16, torch.bfloat16).kp == 512
    assert conv_plan(512, 512, 97, 193, 16, 16, torch.bfloat16).wp == 225


def test_conv2d_dil_rejects_float16_and_mixed_dtypes():
    x, w = torch.zeros(1, 16, 13, 21), torch.zeros(32, 16, 3, 3)
    for args in [(x.half(), w.half(), 4, 4), (x.bfloat16(), w, 4, 4), (x, w.bfloat16(), 4, 4)]:
        with pytest.raises(ValueError):
            conv2d_dil(*args)
