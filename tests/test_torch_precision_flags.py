"""The port's f32 entry points compute without TF32 whatever the caller set.

Inside a ``Streamer`` frame, a ``FrameRunner`` frame, a train step and a direct
call of ``make_loss_of``'s function, each conv (a recording ``F.conv2d``)
sees cuDNN's ``allow_tf32`` False and the f32 matmul precision ``"highest"``,
with the caller's ``allow_tf32`` True and precision ``"high"``; after each,
the caller's settings are back.
"""

import pytest
import torch
import torch.nn.functional as F

from tdnet_tpu_torch.models import PSPNetConfig, init_pspnet, init_tdnet, tdnet_config
from tdnet_tpu_torch.nn import step_generator
from tdnet_tpu_torch.stream.runtime import FrameRunner, Streamer, synthetic_frames
from tdnet_tpu_torch.train.trainer import make_loss_of, make_train_state, make_train_step

IN_SIZE = (33, 49)


@pytest.fixture
def seen(monkeypatch):
    """The (allow_tf32, matmul precision) every conv of the block sees, with the
    caller's settings TF32-friendly, and a check that they are back after."""
    record = []
    conv = F.conv2d

    def recording(*args, **kwargs):
        record.append((torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()))
        return conv(*args, **kwargs)
    monkeypatch.setattr(F, "conv2d", recording)
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    yield record
    assert (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()) == (
        True, "high")
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.set_float32_matmul_precision(matmul)


def _frames():
    return synthetic_frames(2, IN_SIZE, seed=1)


def test_streamer_frame_without_tf32(seen):
    cfg = tdnet_config("td4-psp18", in_size=IN_SIZE)
    runner = Streamer(init_tdnet(cfg, torch.Generator().manual_seed(0)))
    for f in _frames():
        runner.step(f)
    runner.run_pipelined(_frames())
    assert seen and set(seen) == {(False, "highest")}


def test_frame_runner_frame_without_tf32(seen):
    cfg = PSPNetConfig(nclass=5, backbone="resnet10", in_size=IN_SIZE, aux=False)
    runner = FrameRunner(init_pspnet(cfg, torch.Generator().manual_seed(0)))
    runner.step(_frames()[0])
    assert seen and set(seen) == {(False, "highest")}


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_train_step_without_tf32(seen, compute_dtype):
    cfg = tdnet_config("td4-psp18", in_size=IN_SIZE, streaming=False)
    model = init_tdnet(cfg, torch.Generator().manual_seed(0))
    frames = torch.randn(4, 1, *IN_SIZE, 3, generator=torch.Generator().manual_seed(1))
    labels = torch.randint(0, 19, (1, *IN_SIZE), generator=torch.Generator().manual_seed(2))
    step = make_train_step(use_dropout=False, compute_dtype=compute_dtype)
    step(make_train_state(model), frames, labels, 1)
    n_step = len(seen)
    make_loss_of(use_dropout=False, compute_dtype=compute_dtype)(
        model, frames, labels, 2, step_generator(0, 1))
    assert n_step and len(seen) > n_step and set(seen) == {(False, "highest")}
