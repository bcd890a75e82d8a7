"""The execution context of a forward pass (``tdnet_tpu/nn/module.py:25-85``).

``Ctx`` carries the train flag, ``use_dropout`` and the step's random
stream: a CPU ``torch.Generator`` from which every dropout draws, in call
order, the seed of its mask (``next_seed``) or, for ``dropout2d``, the mask
itself. The same generator state gives the same masks on the CPU and on the
card. BatchNorm follows the module's own ``train()`` / ``eval()``; the
trainer sets both together.
"""

from __future__ import annotations

import dataclasses

import torch

from tdnet_tpu_torch.kernels.dropout import dropout


@dataclasses.dataclass
class Ctx:
    train: bool = False
    use_dropout: bool = True  # False: train-mode BN, no dropout (the parity tests)
    generator: torch.Generator | None = None

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


def step_generator(seed: int, it: int) -> torch.Generator:
    """The generator of training step ``it``: a fresh stream from (seed, it),
    the counterpart of ``jax.random.fold_in(rng, it)``."""
    return torch.Generator().manual_seed(((seed & 0xFFFFFFFF) << 32) | (it & 0xFFFFFFFF))
