#!/usr/bin/env python3
"""Drive tdnet_tpu_torch on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
0. toolchain and card: torch, CUDA, nvcc, ``nvidia-smi`` name and power limit;
1. build the propagation-attention kernel from ``tdnet_tpu_torch/csrc``;
2. the kernel against its plain PyTorch version at the streaming hop shapes
   (and a ragged batch of 2), f32 (TF32 off) and bf16, with and without the
   fc; max abs error and the median time of each (CUDA events);
3. TD4-PSP18 at 769x1537 in f32 through ``Streamer`` on seeded random weights
   and 12 seeded synthetic frames, against the same stream with the plain
   attention (1e-3 x max|logits|); 3 kernel launches per warm frame; latency,
   frames/s and peak memory;
4. the same stream in bf16, against its plain-attention run (3e-2 x
   max|logits|) and against the f32 stream (5e-2 x max|f32 logits|);
5. TD2-PSP50 at 1025x2049 in bf16, against its plain-attention run (3e-2 x
   max|logits|); one launch per warm frame.
The line before the last is one JSON object of the kernels, one entry per
dtype, each with its error and times at the TD2 hop with the fc; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

SHAPES = [(1225, 1225), (18721, 1225), (33153, 2145), (700, 130)]   # (Lq, Lkv)
BATCHED = (2, 700, 130)   # (n, Lq, Lkv): the batch axis of the kernel's grid
D_K, D_V = 64, 512
N_FRAMES = 12
SEED = 0
HEADLINE = (1, 33153, 2145)   # the TD2 hop: the case each kernels entry reports


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_toolchain() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    from tdnet_tpu_torch.kernels.build import nvcc as nvcc_path
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} | nvcc: {nvcc} | "
        f"python {sys.version.split()[0]}")
    log(f"[0] card: {smi} | devices: {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from tdnet_tpu_torch.kernels import propagation_attention as pa
    t0 = time.perf_counter()
    pa.build()
    log(f"[1] built propagation_attention.cu in {time.perf_counter() - t0:.1f} s")


def phase_kernel(card: str) -> dict:
    from tdnet_tpu_torch.kernels.propagation_attention import (
        fused_propagation_attention, propagation_attention_plain)
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    headline = {}
    log(f"[2] kernel vs plain ({card}); tolerances: f32 2e-5 (5e-4 with fc), "
        f"bf16 3e-2 x max|ref|")
    for n, lq, lkv in [(1, *shape) for shape in SHAPES] + [BATCHED]:
        host = dict(q=rng.randn(n, lq, D_K), k=rng.randn(n, lkv, D_K),
                    v=rng.randn(n, lkv, D_V), w=rng.randn(D_V, D_V) * 0.05,
                    b=rng.randn(D_V) * 0.1)
        for dtype in (torch.float32, torch.bfloat16):
            t = {n: torch.tensor(a, dtype=torch.float32, device=dev).to(dtype).contiguous()
                 for n, a in host.items()}
            ref_in = {n: x.float() for n, x in t.items()}   # bf16-rounded inputs, in f32
            for fc in (False, True):
                fkw = dict(fc_w=t["w"], fc_b=t["b"]) if fc else {}
                rkw = dict(fc_w=ref_in["w"], fc_b=ref_in["b"]) if fc else {}
                got = fused_propagation_attention(t["q"], t["k"], t["v"], temperature=8.0,
                                                  **fkw)
                torch.cuda.synchronize()
                ref = propagation_attention_plain(ref_in["q"], ref_in["k"], ref_in["v"],
                                                  temperature=8.0, **rkw)
                err = (got.float() - ref).abs().max().item()
                scale = ref.abs().max().item()
                tol = (5e-4 if fc else 2e-5) if dtype == torch.float32 else 3e-2 * scale
                if not (got.shape == ref.shape and np.isfinite(err) and err <= tol):
                    raise AssertionError(f"kernel disagrees at {n}x{lq}x{lkv} {dtype} fc={fc}: "
                                         f"max abs err {err} > {tol}")
                ms = median_ms(lambda: fused_propagation_attention(
                    t["q"], t["k"], t["v"], temperature=8.0, **fkw))
                plain_ms = median_ms(lambda: propagation_attention_plain(
                    t["q"], t["k"], t["v"], temperature=8.0, **fkw))
                name = "bf16" if dtype == torch.bfloat16 else "f32"
                log(f"[2] n={n} {lq:6d} x {lkv:5d} {name:4s} fc={int(fc)}  max_abs_err {err:.3e} "
                    f"(tol {tol:.3e})  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms")
                if (n, lq, lkv) == HEADLINE and fc:
                    headline[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
            del t, ref_in
    return headline


def stream_frames(in_size, dtype):
    from tdnet_tpu_torch.stream.runtime import synthetic_frames
    return synthetic_frames(N_FRAMES, in_size, seed=SEED, device="cuda", dtype=dtype)


@contextlib.contextmanager
def plain_attention():
    """The hops take the plain attention instead of the kernel's wrapper."""
    from tdnet_tpu_torch.kernels import propagation_attention as pa
    from tdnet_tpu_torch.nn import encoding
    encoding.fused_propagation_attention = pa.propagation_attention_plain
    try:
        yield
    finally:
        encoding.fused_propagation_attention = pa.fused_propagation_attention


def check_close(tag, got, want, frac, what):
    """Every frame of ``got`` within ``frac`` x max|want| of ``want``."""
    worst = (0.0, 0.0, 1.0)   # (err / tol, err, tol)
    for i, (a, b) in enumerate(zip(got, want)):
        err = (a.float() - b.float()).abs().max().item()
        tol = frac * b.float().abs().max().item()
        worst = max(worst, (err / tol, err, tol))
        if not err <= tol:
            raise AssertionError(f"[{tag}] frame {i}: {what} logits differ by {err} > {tol}")
    log(f"[{tag}] {what} logits: worst frame max abs diff {worst[1]:.4e} against a bound of "
        f"{worst[2]:.4e} ({frac:g} x max|logits|), {worst[0]:.3f} of it")


def run_stream(arch, in_size, dtype, frames, card, tag, kernel=True):
    """Stream the frames through a fresh seeded model; returns (logits on the
    host, launches). The peak memory is the stream's own: weights, cache and
    activations, not the frames. ``kernel=False``: the attention is the plain
    version, which launches nothing."""
    from tdnet_tpu_torch.kernels.propagation_attention import fused_propagation_attention
    from tdnet_tpu_torch.models import init_tdnet, tdnet_config
    from tdnet_tpu_torch.stream.runtime import Streamer
    cfg = tdnet_config(arch, in_size=in_size)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = init_tdnet(cfg, torch.Generator().manual_seed(SEED)).to("cuda")
    streamer = Streamer(model, dtype=dtype)
    fused_propagation_attention.launches = 0
    outs = [streamer.step(f)[0].cpu() for f in frames]
    launches = fused_propagation_attention.launches
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    for o in outs:
        if o.shape != (1, *in_size, cfg.nclass) or not torch.isfinite(o).all():
            raise AssertionError(f"{tag}: bad logits {tuple(o.shape)}")
    streamer.reset()
    _, spf = streamer.run_pipelined(frames)
    log(f"[{tag}] {arch} {in_size[0]}x{in_size[1]} {str(dtype)[6:]} ({card}): hard-synced "
        f"latency {streamer.meter.avg * 1e3:.2f} ms/frame (frames 7-{N_FRAMES}), pipelined "
        f"{1.0 / spf:.2f} frames/s, peak memory {peak:.0f} MiB, kernel launches {launches}")
    warm = N_FRAMES - cfg.window
    expected = cfg.window * warm if kernel else 0
    if launches != expected:
        raise AssertionError(f"{tag}: {launches} kernel launches, expected {expected}")
    return outs, launches


def main() -> int:
    card = phase_toolchain()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k1 = phase_kernel(card)

    from tdnet_tpu_torch.models import STREAM_SIZE
    td4, td2 = STREAM_SIZE["td4-psp18"], STREAM_SIZE["td2-psp50"]
    f32_frames = stream_frames(td4, torch.float32)
    outs32, n32 = run_stream("td4-psp18", td4, torch.float32, f32_frames, card, "3")
    with plain_attention():
        plain, _ = run_stream("td4-psp18", td4, torch.float32, f32_frames, card, "3-plain",
                              kernel=False)
    check_close("3", outs32, plain, 1e-3, "kernel-path vs plain-attention f32")
    del plain, f32_frames

    bf16_frames = stream_frames(td4, torch.bfloat16)
    outs16, n16 = run_stream("td4-psp18", td4, torch.bfloat16, bf16_frames, card, "4")
    with plain_attention():
        plain, _ = run_stream("td4-psp18", td4, torch.bfloat16, bf16_frames, card, "4-plain",
                              kernel=False)
    check_close("4", outs16, plain, 3e-2, "kernel-path vs plain-attention bf16")
    check_close("4", outs16, outs32, 5e-2, "bf16 vs f32")
    del outs16, outs32, plain, bf16_frames

    td2_frames = stream_frames(td2, torch.bfloat16)
    outs2, n2 = run_stream("td2-psp50", td2, torch.bfloat16, td2_frames, card, "5")
    with plain_attention():
        plain, _ = run_stream("td2-psp50", td2, torch.bfloat16, td2_frames, card, "5-plain",
                              kernel=False)
    check_close("5", outs2, plain, 3e-2, "kernel-path vs plain-attention bf16")

    launches = {"f32": n32, "bf16": n16 + n2}
    log(json.dumps({"kernels": [{
        "name": f"propagation_attention_{dt}", "route": "cuda",
        "source": "tdnet_tpu_torch/csrc/propagation_attention.cu",
        "replaces": "tdnet_tpu/kernels/propagation_attention.py:127",
        "launches": launches[dt], **k1[dt]} for dt in ("f32", "bf16")]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
