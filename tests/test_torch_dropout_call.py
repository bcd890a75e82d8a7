"""K3's call (``kernels/dropout.py``) and its hash in two halves, on the CPU.

- The kernel forms the mask's hash in two halves (``csrc/dropout_hash.cuh``:
  ``tdnet_hash_high`` once a 16-byte vector, whose indices share a high word,
  then ``tdnet_hash_low`` an element): a twin of that split equals
  ``ops/dropout_mask.py:dropout_hash`` bit for bit for random seeds and
  indices on both sides of k * 2^32 (k = 0, 1, 3), where aligned groups of 8
  (bf16) and 4 (f32) indices take one high half.
- The launch arguments (C entry point, element count, the seed's low 32 bits,
  keep threshold, scale per dtype; ``launch_args``) are what the wrapper
  passed before it was redesigned, and the launch passes exactly them.
- On the CPU ``dropout`` is ``dropout_plain`` with and without grad mode, and
  its backward the plain one; the wrapper refuses other devices and dtypes
  rather than taking the plain version.
"""

import numpy as np
import pytest
import torch

from tdnet_tpu_torch.cli.profile import kernel_family
from tdnet_tpu_torch.kernels import dropout as kd
from tdnet_tpu_torch.ops.dropout_mask import (dropout_hash, keep_mask, keep_threshold, mix32,
                                              mix32_int)

RATE = 0.1
M32 = 0xFFFFFFFF
SEEDS = [0, 1, 5, 0x7FFFFFFF, M32, 2**32 + 7, 2**40 + 3]


def hash_high(seed_mix: int, hi: torch.Tensor) -> torch.Tensor:
    """``tdnet_hash_high``: mix32(hi ^ mix32(seed))."""
    return mix32(hi ^ seed_mix)


def hash_low(lo: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """``tdnet_hash_low``: mix32(lo ^ high)."""
    return mix32(lo ^ high)


def kernel_hashes(seed: int, first: int, count: int, lanes: int) -> torch.Tensor:
    """The hashes ``dropout_vec`` forms for the aligned vectors of ``lanes``
    elements covering indices [first, first + count): one high half a vector."""
    assert first % lanes == 0 and count % lanes == 0
    base = torch.arange(first, first + count, lanes, dtype=torch.int64)   # vector starts
    seed_mix = mix32_int(seed & M32)
    high = hash_high(seed_mix, base >> 32)
    lo = (base & M32)[:, None] + torch.arange(lanes)   # a vector never crosses 2^32
    assert int(lo.max()) <= M32
    return hash_low(lo, high[:, None]).reshape(-1)


@pytest.mark.parametrize("lanes", [8, 4])
@pytest.mark.parametrize("k", [0, 1, 3])
def test_hash_halves_match_the_mask_across_high_words(k, lanes):
    rng = np.random.RandomState(k * 10 + lanes)
    first = k * 2**32 - 64 * lanes if k else 0
    for seed in SEEDS + [int(s) for s in rng.randint(0, 2**62, size=4, dtype=np.int64)]:
        count = 128 * lanes
        got = kernel_hashes(seed, first, count, lanes)
        want = dropout_hash(seed, torch.arange(first, first + count, dtype=torch.int64))
        assert torch.equal(got, want), (seed, k, lanes)


@pytest.mark.parametrize("lanes", [8, 4])
def test_launch_below_2_32_takes_one_high_half(lanes):
    """Below 2^32 every vector forms the same high half, that of hi = 0: the
    last vectors below 2^32 and a random stretch in the middle."""
    rng = np.random.RandomState(lanes)
    for seed in SEEDS:
        middle = int(rng.randint(0, 2**32 // (16 * lanes) - 16)) * 16 * lanes
        one_high = hash_high(mix32_int(seed & M32), torch.zeros(1, dtype=torch.int64))
        for first in (2**32 - 256 * lanes, middle):
            idx = torch.arange(first, first + 256 * lanes, dtype=torch.int64)
            got = kernel_hashes(seed, first, 256 * lanes, lanes)
            assert torch.equal(got, dropout_hash(seed, idx))
            assert torch.equal(got, hash_low(idx & M32, one_high))


def test_hash_halves_are_the_mixers():
    """One element by Python ints: the split is the header's formula."""
    for seed in SEEDS:
        for idx in (0, 7, 2**32 - 1, 2**32, 3 * 2**32 + 5):
            hi, lo = idx >> 32, idx & M32
            high = mix32_int(hi ^ mix32_int(seed & M32))
            assert mix32_int(lo ^ high) == int(dropout_hash(seed, torch.tensor([idx]))[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.25, 0.5])
def test_launch_args_are_the_parents(dtype, rate):
    """The parent wrapper passed (numel, seed & 0xFFFFFFFF, keep_threshold(rate),
    1 / (1 - rate) in x's dtype) to tdnet_dropout (f32) or tdnet_dropout_bf16."""
    for seed in SEEDS + [-1, -(2**33) + 5]:
        for n in (0, 8, 18721 * 512, 2**32 + 8):
            entry, count, seed32, threshold, scale = kd.launch_args(n, dtype, rate, seed)
            assert entry == {torch.float32: "tdnet_dropout",
                             torch.bfloat16: "tdnet_dropout_bf16"}[dtype]
            assert (count, seed32, threshold) == (n, seed % 2**32, keep_threshold(rate))
            assert scale == torch.tensor(1.0 / (1.0 - rate), dtype=dtype).item()
    assert kd.launch_args(1, torch.bfloat16, 0.1, 0)[4] == 1.109375


def test_launch_args_refuse_other_dtypes():
    with pytest.raises(ValueError):
        kd.launch_args(8, torch.float16, RATE, 0)


@pytest.mark.parametrize("bad", [torch.zeros(8, 64, dtype=torch.float16),
                                 torch.zeros(64, 8).t(), torch.zeros(8, 64, dtype=torch.float64)])
def test_launch_refuses_what_the_kernel_does_not_take(bad):
    """The checks run before anything touches CUDA."""
    with pytest.raises(ValueError):
        kd._launch(bad, RATE, 0)


def test_dropout_refuses_devices_without_a_kernel():
    with pytest.raises(ValueError):
        kd.dropout(torch.zeros(8, 64, device="meta"), RATE, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad_mode", [True, False])
def test_cpu_dropout_is_the_plain_version(dtype, grad_mode):
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2145, 64).astype(np.float32)).to(dtype)
    seed = 11
    with torch.set_grad_enabled(grad_mode):
        y = kd.dropout(x, RATE, seed)
        yg = kd.dropout(x.clone().requires_grad_(True), RATE, seed)
    want = kd.dropout_plain(x, RATE, seed)
    assert y.dtype == dtype and torch.equal(y, want) and torch.equal(yg.detach(), want)
    assert yg.requires_grad == grad_mode


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_dropout_backward_is_the_plain_one(dtype):
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(700, 96).astype(np.float32)).to(dtype).requires_grad_(True)
    xp = x.detach().clone().requires_grad_(True)
    dy = torch.from_numpy(rng.randn(700, 96).astype(np.float32)).to(dtype)
    kd.dropout(x, RATE, 9).backward(dy)
    kd.dropout_plain(xp, RATE, 9).backward(dy)
    keep = keep_mask(9, RATE, (700, 96))
    scale = torch.tensor(1.0 / (1.0 - RATE), dtype=dtype)
    assert torch.equal(x.grad, xp.grad)
    assert torch.equal(x.grad, torch.where(keep, (dy.float() * scale.float()).to(dtype),
                                           torch.zeros((), dtype=dtype)))


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::dropout_vec<float4, false>(float4 const*, ...)",
    "void (anonymous namespace)::dropout_vec<uint4, true>(uint4 const*, ...)",
    "(anonymous namespace)::dropout_bf16(__nv_bfloat16 const*, ...)",
    "void (anonymous namespace)::dropout_vec<float4>(float4 const*, float4*, unsigned long, ...)",
    "void (anonymous namespace)::dropout_vec<uint4>(uint4 const*, uint4*, unsigned long, ...)",
    "(anonymous namespace)::dropout_bf16x8(uint4 const*, uint4*, unsigned long, ...)"])
def test_profile_names_the_kernels(name):
    assert kernel_family(name, train=True) == "K3 dropout"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_passes_the_parents_arguments(dtype, monkeypatch):
    """The launch itself, its C function and the raw stream getter swapped for
    recorders: the entry point, pointers, count, seed, threshold, scale and
    the stream handle as the parent passed them, every one of them from
    ``launch_args``."""
    seen, entries = [], []

    def function(entry):
        entries.append(entry)
        return lambda *args: seen.append(args) or 0

    monkeypatch.setattr(kd, "_function", function)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1234,
                        raising=False)
    for seed in SEEDS + [-1]:
        for shape in ((8, 64), (0, 512), (3, 5)):
            x = torch.zeros(shape, dtype=dtype)
            y = kd._launch(x, RATE, seed)
            assert y.shape == x.shape and y.dtype == dtype
            assert entries[-1] == {torch.float32: "tdnet_dropout",
                                   torch.bfloat16: "tdnet_dropout_bf16"}[dtype]
            assert seen[-1] == (x.data_ptr(), y.data_ptr(), x.numel(), seed % 2**32,
                                keep_threshold(RATE),
                                torch.tensor(1.0 / (1.0 - RATE), dtype=dtype).item(), 1234)
            assert seen[-1][2:6] == kd.launch_args(x.numel(), dtype, RATE, seed)[1:]
