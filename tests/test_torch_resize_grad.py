"""The port's bilinear resize (``tdnet_tpu_torch/ops/resize.py``): its forward
is ``F.interpolate``'s, its backward the two interpolation-matrix products
dx = A_hᵀ g A_w, held against ``F.interpolate``'s autograd and against
``jax.grad`` of the JAX package's ``resize_bilinear`` on the same seeded
inputs (NCHW against NHWC).

Cases, the recipe's scaled down: the PSP branches' 1/2/3/6 maps up to a
feature grid, and the logits' integer-ratio x8 upsample (the JAX package
takes its two-tap path there, which is the same linear map).

Tolerances: the forward is compared bitwise. The backward sums the same
products as ``F.interpolate``'s in another order: in float64 to 1e-12 x
max|dx|, in f32 to 1e-5 x max|dx| (up to 769 terms of a sum), and to JAX's
f32 gradient (its matmuls at HIGHEST precision) to 1e-5 x max|dx| too.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tdnet_tpu.ops import resize as jresize
from tdnet_tpu_torch.ops import resize_bilinear
from tdnet_tpu_torch.ops.resize import _interp_matrix_np

CASES = [((1, 1), (13, 25)), ((2, 2), (13, 25)), ((3, 3), (13, 25)), ((6, 6), (13, 25)),
         ((13, 25), (97, 193)), ((13, 25), (17, 30))]


def _inputs(in_hw, out_hw, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 5, *in_hw).astype(np.float32)
    g = rng.randn(2, 5, *out_hw).astype(np.float32)
    return x, g


def _grad(fn, x, g):
    leaf = x.clone().requires_grad_(True)
    y = fn(leaf)
    y.backward(g)
    return y.detach(), leaf.grad


def _interpolate(out_hw):
    return lambda t: F.interpolate(t, size=out_hw, mode="bilinear", align_corners=True)


@pytest.mark.parametrize("in_hw,out_hw", CASES)
def test_forward_is_interpolate_bitwise(in_hw, out_hw):
    x, _ = _inputs(in_hw, out_hw)
    x = torch.from_numpy(x)
    assert torch.equal(resize_bilinear(x, out_hw), _interpolate(out_hw)(x))
    assert torch.equal(resize_bilinear(x.bfloat16(), out_hw),
                       _interpolate(out_hw)(x.bfloat16().float()).bfloat16())


@pytest.mark.parametrize("in_hw,out_hw", CASES)
@pytest.mark.parametrize("dtype,frac", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_backward_matches_interpolate_autograd(in_hw, out_hw, dtype, frac):
    x, g = (torch.from_numpy(a).to(dtype) for a in _inputs(in_hw, out_hw))
    _, got = _grad(lambda t: resize_bilinear(t, out_hw), x, g)
    _, want = _grad(_interpolate(out_hw), x, g)
    assert got.dtype == dtype
    assert (got - want).abs().max().item() <= frac * want.abs().max().item()


@pytest.mark.parametrize("in_hw,out_hw", CASES)
def test_backward_matches_jax_grad(in_hw, out_hw):
    x, g = _inputs(in_hw, out_hw)
    to_nhwc = lambda a: np.ascontiguousarray(a.transpose(0, 2, 3, 1))
    loss = lambda t: jnp.sum(jresize.resize_bilinear(t, out_hw) * jnp.asarray(to_nhwc(g)))
    want = np.asarray(jax.grad(loss)(jnp.asarray(to_nhwc(x))))
    _, got = _grad(lambda t: resize_bilinear(t, out_hw), torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(to_nhwc(got.numpy()), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("in_hw,out_hw", CASES[3:5])
def test_two_backwards_are_bitwise_equal(in_hw, out_hw):
    x, g = (torch.from_numpy(a) for a in _inputs(in_hw, out_hw, seed=1))
    a = _grad(lambda t: resize_bilinear(t, out_hw), x, g)[1]
    b = _grad(lambda t: resize_bilinear(t, out_hw), x, g)[1]
    assert torch.equal(a, b)


@pytest.mark.parametrize("n_in,n_out", [(1, 7), (2, 9), (6, 97), (13, 97), (25, 193), (5, 1)])
def test_interp_matrix_is_the_jax_package_s(n_in, n_out):
    np.testing.assert_array_equal(_interp_matrix_np(n_in, n_out),
                                  jresize._interp_matrix_np(n_in, n_out, True))


def test_bf16_input_gets_a_bf16_gradient():
    x, g = (torch.from_numpy(a) for a in _inputs((6, 6), (13, 25)))
    _, got = _grad(lambda t: resize_bilinear(t, (13, 25)), x.bfloat16(), g.bfloat16())
    _, want = _grad(lambda t: resize_bilinear(t, (13, 25)), x, g.bfloat16().float())
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.bfloat16().float(), rtol=0, atol=0)
