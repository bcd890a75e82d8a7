"""The execution context of a forward pass (``tdnet_tpu/nn/module.py:25-85``).

``Ctx`` carries the train flag, ``use_dropout`` and the step's random
stream: a CPU ``torch.Generator`` from which every dropout draws, in call
order, the seed of its mask (``next_seed``) or, for ``dropout2d``, the mask
itself. The same generator state gives the same masks on the CPU and on the
card. BatchNorm follows the module's own ``train()`` / ``eval()``; the
trainer sets both together.

Two options pick a kernel on the backbone's path (``tdnet_tpu/nn/module.py:31,36``):
- ``stem_impl``: ``"plain"`` (the unfused ops) or ``"fused"``, the fused
  deep-base stem tail K4 (``kernels/fused_stem.py``), taken only by deep-base
  backbones in eval mode; elsewhere the stem stays plain;
- ``conv_wgrad``: ``"cudnn"`` (the convs through ``F.conv2d`` and autograd) or
  ``"kernel"``, the JAX package's ``"pallas"``: in training, the blocks' 3x3
  convs with stride 1 and dilation >= 4 go through K5
  (``kernels/dilated_conv.py``: the kernel for the forward and the dgrad,
  per-tap matmuls for the weight gradient).

``fused_trunk`` (``tdnet_tpu/nn/module.py:37``) takes the streaming step
through the z-free grouped-PSP + QKV encoding (``nn/fused_trunk.py``), in eval
only; the ``Streamer`` turns it on by default, as the JAX ``Streamer`` does.
"""

from __future__ import annotations

import dataclasses

import torch

from tdnet_tpu_torch.kernels.dropout import dropout

STEM_IMPLS = ("plain", "fused")
CONV_WGRADS = ("cudnn", "kernel")


@dataclasses.dataclass
class Ctx:
    train: bool = False
    use_dropout: bool = True  # False: train-mode BN, no dropout (the parity tests)
    generator: torch.Generator | None = None
    stem_impl: str = "plain"
    conv_wgrad: str = "cudnn"
    fused_trunk: bool = False

    def __post_init__(self):
        if self.stem_impl not in STEM_IMPLS:
            raise ValueError(f"stem_impl {self.stem_impl!r} not in {STEM_IMPLS}")
        if self.conv_wgrad not in CONV_WGRADS:
            raise ValueError(f"conv_wgrad {self.conv_wgrad!r} not in {CONV_WGRADS}")

    @property
    def dropping(self) -> bool:
        return self.train and self.use_dropout

    def next_seed(self) -> int:
        """A fresh 32-bit mask seed from the generator."""
        if self.generator is None:
            raise ValueError("Ctx.generator is required for dropout in train mode")
        return int(torch.randint(0, 2**32, (), dtype=torch.int64, generator=self.generator))

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """Elementwise dropout: the K3 kernel on CUDA tensors, its plain version
        on CPU tensors (``kernels/dropout.py``)."""
        if not self.dropping or rate <= 0.0:
            return x
        return dropout(x, rate, self.next_seed())

    def dropout2d(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """torch Dropout2d on NCHW ``x``: whole (n, c) planes dropped, the
        Bernoulli(1 - rate) mask drawn from the generator."""
        if not self.dropping or rate <= 0.0:
            return x
        if self.generator is None:
            raise ValueError("Ctx.generator is required for dropout in train mode")
        draw = torch.rand((x.shape[0], x.shape[1], 1, 1), generator=self.generator)
        keep = (draw >= rate).to(x.device)
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype))


def step_generator(seed: int, it: int, rank: int = 0) -> torch.Generator:
    """The generator of training step ``it``: a fresh stream from (seed, it),
    the counterpart of ``jax.random.fold_in(rng, it)``. Rank r of a data group
    draws its own stream (its dropout masks start at its own row 0, so a shared
    seed would repeat rank 0's masks); rank 0 keeps the one-process stream."""
    key = ((seed & 0xFFFFFFFF) << 32) | (it & 0xFFFFFFFF)
    return torch.Generator().manual_seed(key ^ ((rank * 0x9E3779B97F4A7C15) & (2**64 - 1)))
