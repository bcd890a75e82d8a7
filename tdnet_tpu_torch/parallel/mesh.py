"""The data axis: one process a rank, each with its share of every global batch
(``tdnet_tpu/parallel/mesh.py:28-38, 87-99``).

The reference trains with DataParallel and NCCL ``SyncBatchNorm``
(Training/train.py:77); the JAX package shards the batch over the ``data``
axis of its mesh, and GSPMD turns the batch moments and the gradient
reduction into all-reduces. Here the same reductions are written out:
``ops/norm.py`` all-reduces the batch moments, ``train/trainer.py`` the
gradients, ``train/metrics.py`` the confusion matrix.

``init_distributed`` reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or takes the JAX function's
arguments, and returns a ``DataGroup``. A world of 1 has no process group, and
every caller then runs its one-process code. The backend is NCCL where each
rank has a card of its own, gloo on the CPU or where ranks share a card (torch's
gloo all-reduces CUDA tensors as they are).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass
class DataGroup:
    rank: int = 0
    world: int = 1
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))
    group: object | None = None   # the torch.distributed process group; None at world 1
    backend: str | None = None
    owner: bool = False           # init_distributed made the default group

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over the group in place (and returned); not differentiable."""
        if self.group is None:
            return t
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` overwritten in place by rank ``src``'s."""
        if self.group is None:
            return t
        dist.broadcast(t, src=src, group=self.group)
        return t

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def close(self) -> None:
        """End the process group if ``init_distributed`` made it."""
        if self.owner and dist.is_initialized():
            dist.destroy_process_group()
        self.group, self.owner = None, False


def _env_int(name: str, default: int | None) -> int | None:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None, process_id: int | None = None, *,
                     device: str = "cuda") -> DataGroup:
    """The data group of this process.

    The arguments are the JAX function's (``coordinator_address`` as
    ``host:port``); left out, they come from torchrun's environment. A world of 1
    makes no process group. ``device="cuda"`` gives rank r the card
    ``LOCAL_RANK % device_count`` and makes it current; ``"cpu"`` keeps every
    rank on the CPU. The backend is NCCL where each rank has its own card, else
    gloo."""
    world = num_processes or _env_int("WORLD_SIZE", 1)
    rank = process_id if process_id is not None else _env_int("RANK", 0)
    local = _env_int("LOCAL_RANK", rank)
    dev = torch.device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("init_distributed(device='cuda'): no CUDA device")
        dev = torch.device("cuda", local % cards if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    if world <= 1:
        return DataGroup(device=dev)
    own_card = dev.type == "cuda" and _env_int("LOCAL_WORLD_SIZE", world) <= \
        torch.cuda.device_count()
    backend = "nccl" if own_card else "gloo"
    if coordinator_address is not None:
        url = f"tcp://{coordinator_address}"
    else:
        url = (f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}:"
               f"{os.environ.get('MASTER_PORT', '29500')}")
    owner = not dist.is_initialized()
    if owner:
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=url, world_size=world, rank=rank, **kw)
    return DataGroup(rank=rank, world=world, device=dev, group=dist.group.WORLD,
                     backend=backend, owner=owner)
