"""Every kernel wrapper launches with its tensors' CUDA device current, on that
device's stream; the bf16 kernels' error word is one a device.

A C entry launches on the calling thread's current device, and keeps its
shared-memory opt-in and tensor maps by that device (``csrc/hopper.cuh``:
``allow_smem``, ``MapCache``), so a wrapper that launched on another device's
tensors with device 0 current would skip the opt-in there. Without a card the
launches are read through recorders: each wrapper's low-level launch is called
on CPU tensors that claim CUDA device 3 (``Tensor.get_device``), with
``torch.cuda.device`` replaced by a recorder of the current device, the raw
stream getter by one that names the device it was asked for, and the library
by a stub whose every C entry records the device current when it was called
and the stream it was given. The launch on a second card itself runs in
``chip_smoke.py`` phase 22(d).
"""

import types

import pytest
import torch

from tdnet_tpu_torch.kernels import dilated_conv as dc
from tdnet_tpu_torch.kernels import dropout as kd
from tdnet_tpu_torch.kernels import fault
from tdnet_tpu_torch.kernels import fused_stem as fs
from tdnet_tpu_torch.kernels import propagation_attention as pa
from tdnet_tpu_torch.kernels import propagation_attention_train as pat
from tdnet_tpu_torch.kernels.grid import attention_bf16_plan

DEVICE = 3


class _Lib:
    """Every attribute a C entry that records (entry, the current device, its
    last argument: the stream) and succeeds."""

    def __init__(self, calls, current):
        self._calls, self._current = calls, current

    def __getattr__(self, name):
        def entry(*args):
            self._calls.append((name, self._current[-1] if self._current else None, args[-1]))
            return 0
        return entry


@pytest.fixture
def launches(monkeypatch):
    calls, current = [], []

    class Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            current.append(self.index)

        def __exit__(self, *exc):
            current.pop()

    lib = _Lib(calls, current)
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index,
                        raising=False)
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: DEVICE)
    for mod in (pa, pat, dc):
        monkeypatch.setattr(mod, "fault_word", lambda device: torch.zeros(1, dtype=torch.int32))
    for mod in (pa, pat, fs):
        monkeypatch.setattr(mod, "sm_count", lambda index: 132)
        monkeypatch.setattr(mod, "build", lambda: lib)
    monkeypatch.setattr(dc, "build", lambda: lib)
    monkeypatch.setattr(kd, "_function", lambda entry: getattr(lib, entry))
    return calls


def _attention(dtype, lq=64, lkv=128, dv=128):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(1, lq, 64, generator=g).to(dtype),
            torch.randn(1, lkv, 64, generator=g).to(dtype),
            torch.randn(1, lkv, dv, generator=g).to(dtype))


def _k1_f32():
    q, k, v = _attention(torch.float32)
    pa._launch_f32(q, k, v, 8.0, torch.zeros(128, 128), torch.zeros(128),
                   pa.forward_plan(1, 64, 128, 128, 132))


def _k1_bf16():
    q, k, v = _attention(torch.bfloat16)
    pa.launch_bf16(q, k, v, 8.0, None, None, attention_bf16_plan(1, 64, 128, 128, 132))


def _k2_f32():
    q, k, v = _attention(torch.float32)
    ctx = types.SimpleNamespace()
    ctx.save_for_backward = lambda *t: setattr(ctx, "saved_tensors", t)
    pat._AttentionTrainKernel.forward(ctx, q, k, v, 8.0, 0.1, 5)
    pat._AttentionTrainKernel.backward(ctx, torch.zeros(1, 64, 128))


def _k2_bf16():
    q, k, v = _attention(torch.bfloat16)
    o, stats, bits = pat.launch_bf16_forward(q, k, v, 8.0, 0.1, 5)
    pat.launch_bf16_backward(q, k, v, torch.zeros_like(o), stats, bits, 8.0, 0.1, 5)


def _k3():
    kd._launch(torch.zeros(64, 128), 0.1, 5)


def _k4():
    tail = types.SimpleNamespace(chunks=torch.zeros(16), sb1=torch.zeros(2, 64),
                                 sb2=torch.zeros(2, 128))
    fs.launch(torch.zeros(1, 64, 16, 16), tail)


def _k5(dtype):
    x, w = torch.zeros(1, 32, 16, 16, dtype=dtype), torch.zeros(32, 32, 3, 3, dtype=dtype)
    dc.launch(x, w, 4, 4)
    dc.launch(x, w, 4, 4, flip=True)


WRAPPERS = {"K1 f32": (_k1_f32, 1), "K1 bf16": (_k1_bf16, 1), "K2 f32": (_k2_f32, 2),
            "K2 bf16": (_k2_bf16, 2), "K3": (_k3, 1), "K4": (_k4, 1),
            "K5 f32": (lambda: _k5(torch.float32), 2), "K5 bf16": (lambda: _k5(torch.bfloat16), 2)}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_launches_on_its_tensors_device(launches, name):
    run, count = WRAPPERS[name]
    run()
    assert len(launches) == count, launches
    for entry, device, stream in launches:
        assert (device, stream) == (DEVICE, 1000 + DEVICE), (entry, device, stream)


def test_cpu_tensors_change_no_device(monkeypatch):
    """On a CPU tensor (index -1) ``on_device`` enters no device: torch's own
    ``torch.cuda.device(-1)`` is a no-op, which the K3 CPU test relies on."""
    from tdnet_tpu_torch.kernels.device import on_device
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: index,
                        raising=False)
    with on_device(torch.zeros(1)) as stream:
        assert stream == -1


def test_error_words_are_one_a_device(monkeypatch):
    """Two devices' words are two tensors; a fault on one is read, and cleared,
    on that device only; a device without an index is the current one."""
    zeros = torch.zeros
    monkeypatch.setattr(fault, "_words", {})
    monkeypatch.setattr(torch, "zeros", lambda *a, device=None, **kw: zeros(*a, **kw))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    w0, w1 = fault.fault_word("cuda:0"), fault.fault_word("cuda:1")
    assert w0 is not w1 and fault.fault_word("cuda") is w1
    w1.fill_(1)
    fault.check_fault("cuda:0")
    with pytest.raises(RuntimeError, match="gave up"):
        fault.check_fault("cuda:1")
    assert int(w1) == 0
    fault.check_fault("cuda:1")
    fault.check_fault("cpu")
