#!/usr/bin/env python3
"""Drive tdnet_tpu_torch on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
0. toolchain and card: torch, CUDA, nvcc, ``nvidia-smi`` name and power limit;
1. build every kernel library from ``tdnet_tpu_torch/csrc``, one nvcc each,
   all at once;
2. the propagation-attention kernel (K1) against its plain PyTorch version at
   the streaming hop shapes (and a ragged batch of 2), f32 (TF32 off) and
   bf16, with and without the fc; max abs error and the median time of each
   (CUDA events), and the kernels each f32 call runs with their device times
   (a ``torch.profiler`` trace); at the TD2 hop with the fc,
   ``F.scaled_dot_product_attention`` followed by ``torch.addmm`` (the same
   function), SDPA alone, and the bound both ways (f32 on the CUDA cores,
   3xTF32 on the tensor cores);
3. TD4-PSP18 at 769x1537 in f32 through ``Streamer`` on seeded random weights
   and 12 seeded synthetic frames, against the same stream with the plain
   attention (1e-3 x max|logits|); 3 kernel launches per warm frame; latency,
   frames/s and peak memory;
4. the same stream in bf16, against its plain-attention run (3e-2 x
   max|logits|) and against the f32 stream (5e-2 x max|f32 logits|);
5. TD2-PSP50 at 1025x2049 in bf16, against its plain-attention run (3e-2 x
   max|logits|); one launch per warm frame;
6. load the training libraries (K2: training attention, K3: dropout);
7. K2 against its plain version at the TD4 training hop shapes (2,145 x 2,145,
   run twice a step, and 18,721 x 2,145), f32, dropout off and on with one
   seed: the output to 1e-5 x max|output| and dq, dk, dv from a seeded dy to
   atol 2e-4 / rtol 1e-3; the keep rate within 0.9 +- 1e-3 (uniform scores,
   v of ones: each output row counts its kept keys); the forward and the
   backward (3xTF32 on the tensor cores) bitwise equal across two runs; each
   forward's rms distance from a float64 forward, kernel and plain, reported,
   not held to a bound (the kernel sums p v in key order, as cuBLAS's FFMA
   GEMM does at the last hop, where the two lie equally far; at 2,145 x 2,145
   cuBLAS splits the keys and lies closer); at each hop, kernel, plain and
   ``F.scaled_dot_product_attention`` (scale 1/8, no dropout) times, forward
   and backward, the kernels that the kernel's and SDPA's forward and
   backward run with their device times (from a ``torch.profiler`` trace),
   and the forward's and the backward's bounds both ways (f32 on the CUDA
   cores, 3xTF32 on the tensor cores); both hops' forward times beside
   SDPA's on one line;
8. K3 against its plain version at [18,721, 512] and [2,145, 512]: output and
   backward (from a seeded dy) bit-identical, the same mask; keep rate within
   0.9 +- 1e-3;
   kernel, plain and ``F.dropout`` times, and the device time of K3's and
   ``F.dropout``'s kernels from one ``torch.profiler`` trace of both;
9. the TD4-PSP18 full training recipe at 769x1537, batch 1, f32: seeded
   student and ResNet-101 teacher, OHEM, KD, AdaOptimizer; a warm-up step and
   8 steps with pos_id 0-3, every loss finite, 3 launches a step of each of K2
   forward, K2 backward, K3 forward and K3 backward; ms/step and peak memory;
   then, from the recipe's seeded initial state at pos_id 1 (the same in
   every run: the state after the timed steps carries the nondeterministic
   backward's noise, and with it whether a ReLU input sits within an f32
   rounding of zero and flips between the paths), dropout off and then on
   (the same masks), one float64 run (the cuDNN path in float64, K2 and K3
   swapped for their plain versions, which take float64), which phase 14
   reuses, and the kernel path held by two rules, each a gate:
   - against float64, beside the plain path (K2 and K3 swapped for their
     plain versions): both losses to 1e-4 relative of float64's, and each
     gradient of the kernel path no farther from float64 than twice the
     plain path's distance plus 1e-3 x max(max|grad|, floor), the floor
     1e-5 x the float64 run's largest max|grad| (for gradients that vanish
     in exact arithmetic, such as a bias before a BatchNorm);
   - against the plain path: the loss to 1e-4 relative of the plain path's,
     each gradient to 1e-3 x max(max|grad|, floor) plus twice the kernel
     path's own run-to-run difference, which must stay within
     1e-2 x max|grad| on every gradient above the floor.
   Whether the kernel path's two identical steps repeat bit for bit is
   printed, and where they do not, the largest difference and its gradient.
   A forward that rounds otherwise than the plain path's GEMM flips some
   ReLUs and fails the second rule while it passes the first; the first
   alone passes a forward off by 1e-3 on one 64-row q block of the last hop
   (PERF.md, run A1), which the second flags. So phase 9 also runs that
   perturbed kernel path (the probe, ``PROBE_EPS``) and fails if its check
   does not flag it; the probe's share of each rule's limit is printed;
10. the fused deep-base stem tail (K4) against its plain version (the unfused
    cuDNN conv / BN / ReLU / max-pool sequence) at the TD2-PSP50 stem shape
    [1, 64, 513, 1025], the PSP-101 one [1, 64, 385, 769] and a small ragged
    one, f32 (TF32 off; 1e-4 x max|ref|) and bf16 (2e-2 x max|ref|: one bf16
    ulp before a BN can carry through conv2); two calls bitwise equal; kernel
    and plain times, at the TD2 shape the device time of the kernel and of the
    plain sequence from one trace, and the bound on the tensor cores (bf16;
    f32 in 3xTF32, with the CUDA cores' beside it);
11. TD2-PSP50 at 1025x2049 through ``Streamer(stem_impl="fused")``, in bf16
    and in f32; one K4 launch a frame and K1's launches as in phase 5; in
    each fused run, the stem tail of every frame, fused against plain with
    the backbone that took the frame, on the run's weights (the runner's K4
    layout), by phase 10's rules. The f32 logits against the plain-stem f32
    stream to 1e-3 x max|logits|. In bf16 that check is the gate: the kernel
    and cuDNN sum a conv in another order, so a few stem outputs round one
    bf16 ulp apart, and the random-weight net spreads that as it spreads any
    bf16 rounding, to about half of max|logits|, as far as the plain bf16
    stream lies from f32; so the fused bf16 stream's distances from the
    plain-stem bf16 stream (phase 5's) and from f32 are reported, not held
    to a bound;
12. PSP-101 at 769x1537 (``FrameRunner``, seeded weights, the 12 frames), f32
    and bf16, the fused stem against the plain stem by phase 11's rules (the
    stem tail of every frame; f32 logits to 1e-3 x max|logits|; bf16 logits
    reported); one K4 launch a frame; latency, frames/s and peak memory;
13. the dilated-conv kernel (K5) against its plain version at the recipe's
    layer4 shapes (97x193 grid; 256->512 d4, 512->512 d4 and d8), f32 with
    TF32 off: forward and dgrad to 5e-5 x max|ref|, and the autograd
    function's output, dx and dW against ``F.conv2d`` autograd (dW 1e-4 x
    max|ref|: a sum over 18,721 pixels); two identical calls bitwise equal,
    forward and dgrad; kernel, plain and cuDNN times (``F.conv2d``,
    ``torch.nn.grad.conv2d_input``) and the bound both ways (3xTF32 on the
    tensor cores, the kernels line's, and f32 on the CUDA cores); at 512->512
    d4 the kernels that K5's and cuDNN's forward and dgrad run, with their
    device times (one trace of both) and the prep passes' share;
14. the phase-9 recipe with ``conv_wgrad="kernel"``: a warm-up step and 4
    steps, every loss finite, 16 forward and 16 dgrad K5 launches a step,
    ms/step and peak memory; then, from phase 9's initial state, dropout off
    and on, the loss and every gradient of the K5 path against phase 9's
    float64 run, beside the default cuDNN path, by phase 9's float64 rule:
    the losses to 1e-4 relative, and each K5 gradient no farther from float64
    than twice the cuDNN one plus 1e-3 x max(max|grad|, floor). Phase 9's
    kernel-vs-plain rule does not apply here: K5 and cuDNN sum layer4's convs
    in other orders, and at random init f32 gradients of the recipe move by
    up to a few percent of max|grad| when one ReLU flips, on both paths
    alike. The evidence is
    printed beside it: the farthest gradient from float64 of two more f32
    variants, deterministic cuDNN and K5's plain version on the card, and
    how many gradients' limits the cuDNN term dominates and how many K5
    gradients needed it.
The line before the last is one JSON object of the kernels: K1 per dtype (its
error and times at the TD2 hop with the fc), K2 forward, K2 backward, K3, K4
per dtype (at the TD2 stem shape) and K5 forward and dgrad (at 512->512 d4),
each with launches, error, times, library time and bound (K1's library time
is SDPA followed by ``torch.addmm``, with SDPA alone beside it; K3, K4 and K5
add their device time; K4 f32 its bound on the CUDA cores beside the 3xTF32
one); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

SHAPES = [(1225, 1225), (18721, 1225), (33153, 2145), (700, 130)]   # (Lq, Lkv)
TRAIN_SHAPES = [(2145, 2145), (18721, 2145)]   # the TD4 training hops (Lq, Lkv)
DROP_ROWS = [18721, 2145]                       # K3's [rows, 512] on the training path
TRAIN_STEPS = 8
K5_STEPS = 4
STEM_SHAPES = [(513, 1025), (385, 769), (21, 35)]   # K4's input (H, W): TD2, PSP-101, ragged
K5_GRID = (97, 193)                                 # the recipe's c4 grid at 769x1537
K5_SHAPES = [(256, 512, 4), (512, 512, 4), (512, 512, 8)]   # layer4's (ci, co, dilation)
K5_HEADLINE = (512, 512, 4)
GRAD_RTOL = 1e-3     # per gradient tensor, x max(max|grad|, floor), in phases 9 and 14
GRAD_FLOOR = 1e-5    # x the run's largest max|grad|: below it a gradient counts as vanishing
LOSS_RTOL = 1e-4     # each f32 path's loss against the float64 run's
NOISE_LIMIT = 1e-2   # the largest 2 x run-to-run / max|grad| allowed above the floor
POS_ID = 1           # the path whose step phases 9 and 14 compare
# phase 9's probe: K2's forward off by a relative PROBE_EPS on one 64-row q block (the 147th
# of 293) of the recipe's last hop, the smallest of 1e-4, 1e-3 and 1e-2 that the
# kernel-vs-plain rule flagged with dropout off and on (PERF.md, run A1)
PROBE_EPS = 1e-3
PROBE_LQ = TRAIN_SHAPES[-1][0]   # the last hop's q rows
PROBE_ROWS = slice(146 * 64, 147 * 64)
# the H100 SXM's published peaks (NVIDIA's H100 datasheet): bytes/s of HBM3,
# FLOP/s of f32 on the CUDA cores and of bf16 on the tensor cores; f32 products in
# 3xTF32 on the tensor cores take three TF32 products each
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32X3 = 495e12 / 3
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


def bound(flops: float, nbytes: float, peak_flops: float) -> dict:
    """The least time of the work on this card: the larger of its operations
    at the peak rate of their type and its bytes at the memory rate."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def phase_build() -> None:
    from tdnet_tpu_torch.kernels import dilated_conv, dropout, fused_stem, \
        propagation_attention, propagation_attention_train
    from tdnet_tpu_torch.kernels.build import compile_libraries
    mods = (propagation_attention, propagation_attention_train, dropout, fused_stem,
            dilated_conv)
    t0 = time.perf_counter()
    compile_libraries({m.__name__.rsplit(".", 1)[1]: m.SOURCES for m in mods})
    log(f"[1] built {', '.join(s for m in mods for s in m.SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, concurrently)")
    propagation_attention.build()


def device_rows(*fns, steps: int = 3) -> list[tuple[str, float]] | None:
    """The kernels that one call of each of ``fns`` runs, with their device
    ms, from a ``torch.profiler`` trace: one warm-up step (a trace started at
    a call dropped its first launches), then ``steps`` traced steps,
    averaged; the profiler's own step rows left out. A trace that holds no
    kernel, or in which a kernel's launches are not a multiple of ``steps``
    (a trace can lack one step's launches), is taken again, up to twice
    more; if the last is still such a trace, it is logged and None
    is returned: the device time is then not measured."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        traced = []
        with torch.profiler.profile(
                activities=acts, schedule=torch.profiler.schedule(wait=0, warmup=1, active=steps),
                on_trace_ready=lambda p: traced.append(p.key_averages())) as prof:
            for _ in range(1 + steps):
                for fn in fns:
                    fn()
                torch.cuda.synchronize()
                prof.step()
        rows = [(r.key, r.self_device_time_total / 1e3, r.count) for r in traced[0]
                if r.device_type == torch.autograd.DeviceType.CUDA
                and not r.key.startswith("ProfilerStep")]
        if rows and all(count % steps == 0 for _, _, count in rows):
            return sorted(((key, ms / steps) for key, ms, _ in rows), key=lambda r: -r[1])
    log(f"device time not measured: the third trace of {steps} steps held launches "
        f"{[(key[:40], count) for key, _, count in rows]}")
    return None


def device_kernels(fn) -> str:
    """``device_rows`` of ``fn`` as one line."""
    rows = device_rows(fn)
    if rows is None:
        return "not measured"
    return "; ".join(f"{key[:90]} {ms:.3f}" for key, ms in rows)


def attention_bounds(n, lq, lkv, fc, nbytes) -> dict:
    """The forward's bound both ways: every product in f32 on the CUDA cores,
    and in 3xTF32 on the tensor cores (the card's rate for f32-accurate
    products, and K1's route for p v and the fc)."""
    flops = 2 * n * lq * lkv * (D_K + D_V) + (2 * n * lq * D_V * D_V if fc else 0)
    return dict(flops=flops, f32=bound(flops, nbytes, PEAK_F32),
                tf32x3=bound(flops, nbytes, PEAK_TF32X3))


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
                run = lambda: fused_propagation_attention(t["q"], t["k"], t["v"],
                                                          temperature=8.0, **fkw)
                ms = median_ms(run)
                plain_ms = median_ms(lambda: propagation_attention_plain(
                    t["q"], t["k"], t["v"], temperature=8.0, **fkw))
                name = "bf16" if dtype == torch.bfloat16 else "f32"
                log(f"[2] n={n} {lq:6d} x {lkv:5d} {name:4s} fc={int(fc)}  max_abs_err {err:.3e} "
                    f"(tol {tol:.3e})  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms")
                if dtype == torch.float32:
                    log(f"[2]   kernels (device ms): {device_kernels(run)}")
                if (n, lq, lkv) == HEADLINE and fc:
                    sdpa = lambda: F.scaled_dot_product_attention(
                        t["q"], t["k"], t["v"], scale=1.0 / 8.0)
                    sdpa_ms = median_ms(sdpa)
                    # the same function as the kernel with the fc: SDPA, then addmm
                    lib_ms = median_ms(lambda: torch.addmm(t["b"], sdpa().view(-1, D_V), t["w"]))
                    nbytes = t["q"].element_size() * (
                        n * lq * (D_K + D_V) + n * lkv * (D_K + D_V) + D_V * D_V + D_V)
                    b = attention_bounds(n, lq, lkv, fc, nbytes)
                    kernel_bound = b["tf32x3"] if dtype == torch.float32 else \
                        bound(b["flops"], nbytes, PEAK_BF16)
                    headline[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                          library_ms=lib_ms, library_sdpa_ms=sdpa_ms,
                                          **kernel_bound)
                    log(f"[2]   F.scaled_dot_product_attention then torch.addmm (the fc) "
                        f"{lib_ms:.3f} ms, SDPA alone {sdpa_ms:.3f} ms; {b['flops'] / 1e9:.2f} "
                        f"GFLOP, bound {kernel_bound['bound_ms']:.3f} ms by "
                        f"{kernel_bound['bound_by']}" + (
                            f" in 3xTF32 on the tensor cores ({PEAK_TF32X3 / 1e12:.0f} TFLOP/s), "
                            f"{b['f32']['bound_ms']:.3f} ms in f32 on the CUDA cores"
                            if dtype == torch.float32 else " in bf16"))
            del t, ref_in
    return headline


def stream_frames(in_size, dtype):
    from tdnet_tpu_torch.stream.runtime import synthetic_frames
    return synthetic_frames(N_FRAMES, in_size, seed=SEED, device="cuda", dtype=dtype)


@contextlib.contextmanager
def swapped(module, name: str, replacement):
    """``module.name`` is ``replacement`` inside the block."""
    original = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield
    finally:
        setattr(module, name, original)


def plain_attention():
    """The streaming hops take the plain attention instead of the kernel's wrapper."""
    from tdnet_tpu_torch.kernels import propagation_attention as pa
    from tdnet_tpu_torch.nn import encoding
    return swapped(encoding, "fused_propagation_attention", pa.propagation_attention_plain)


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


def drive(make_runner, frames, card, tag, what):
    """Step the frames one at a time through the runner ``make_runner()``
    builds, then once pipelined; returns (logits on the host, K1 launches, K4
    launches) of the stepped run. The peak memory is the run's own: weights,
    cache and activations, not the frames."""
    from tdnet_tpu_torch.kernels.fused_stem import fused_stem_tail
    from tdnet_tpu_torch.kernels.propagation_attention import fused_propagation_attention
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    runner = make_runner()
    fused_propagation_attention.launches = 0
    fused_stem_tail.launches = 0
    outs = [runner.step(f)[0].cpu() for f in frames]
    launches = (fused_propagation_attention.launches, fused_stem_tail.launches)
    if runner.ctx.stem_impl == "fused":
        check_stem(tag, runner, frames)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    cfg = runner.cfg
    for o in outs:
        if o.shape != (1, *cfg.in_size, cfg.nclass) or not torch.isfinite(o).all():
            raise AssertionError(f"{tag}: bad logits {tuple(o.shape)}")
    runner.reset()
    _, spf = runner.run_pipelined(frames)
    log(f"[{tag}] {what} {cfg.in_size[0]}x{cfg.in_size[1]} {str(runner.dtype)[6:]} stem "
        f"{runner.ctx.stem_impl} ({card}): hard-synced latency {runner.meter.avg * 1e3:.2f} "
        f"ms/frame (frames 7-{N_FRAMES}), pipelined {1.0 / spf:.2f} frames/s, peak memory "
        f"{peak:.0f} MiB, launches K1 {launches[0]} K4 {launches[1]}")
    return outs, *launches


def report_bf16_stream(tag, fused, plain, ref, what):
    """How far the fused bf16 stream lies from the plain-stem bf16 stream and
    from ``ref`` (the f32 stream), beside the plain bf16 stream's own
    distance from it: a report; the stem check inside the run is the gate."""
    dist = lambda xs, ys: max((a.float() - r.float()).abs().max().item() for a, r in zip(xs, ys))
    d_fused, d_plain = dist(fused, ref), dist(plain, ref)
    log(f"[{tag}] {what} logits (report): fused vs plain {dist(fused, plain):.4e}; distance "
        f"from f32: fused {d_fused:.4e}, plain {d_plain:.4e} ({d_fused / d_plain:.3f} of it); "
        f"max|f32 logits| {max(r.float().abs().max().item() for r in ref):.4e}")


def check_stem(tag, runner, frames) -> None:
    """K4 inside a fused run: the stem tail of every frame, fused against
    plain, with the backbone that took the frame (path ``i % path_num`` of a
    TDNet) on the run's weights (BNs folded, the runner's K4 layout), by
    phase 10's rules."""
    from tdnet_tpu_torch.ops import max_pool
    model = runner.model
    backbones = [p.backbone for p in model.paths] if hasattr(model, "paths") \
        else [model.backbone]
    frac = 2e-2 if runner.dtype == torch.bfloat16 else 1e-4
    worst = 0.0
    with torch.inference_mode():
        for i, f in enumerate(frames):
            bb = backbones[i % len(backbones)]
            x = f.to(runner.dtype).permute(0, 3, 1, 2).contiguous()
            got = bb.stem.fused(x, bb.bn1)
            want = max_pool(bb.bn1(bb.stem(x), "relu"), 3, 2, 1)
            err = (got.float() - want.float()).abs().max().item()
            tol = frac * want.float().abs().max().item()
            worst = max(worst, err / tol)
            if not (got.shape == want.shape and err <= tol):
                raise AssertionError(f"[{tag}] frame {i}: stem tail in the run, fused vs plain "
                                     f"{err} > {tol}")
    log(f"[{tag}] stem tail of all {len(frames)} frames in the run ({len(backbones)} "
        f"backbone(s)), fused vs plain: worst {worst:.3f} of {frac:g} x max|ref|")


def run_stream(arch, in_size, dtype, frames, card, tag, kernel=True, stem_impl="plain"):
    """Stream the frames through a fresh seeded TDNet; returns (logits on the
    host, K1 launches, K4 launches). ``kernel=False``: the attention is the
    plain version, which launches nothing."""
    from tdnet_tpu_torch.models import init_tdnet, tdnet_config
    from tdnet_tpu_torch.nn import BACKBONES
    from tdnet_tpu_torch.stream.runtime import Streamer
    cfg = tdnet_config(arch, in_size=in_size)
    deep_base = BACKBONES[cfg.backbone]().deep_base
    outs, launches, stem_launches = drive(
        lambda: Streamer(init_tdnet(cfg, torch.Generator().manual_seed(SEED)).to("cuda"),
                         dtype=dtype, stem_impl=stem_impl), frames, card, tag, arch)
    warm = N_FRAMES - cfg.window
    expected = (cfg.window * warm if kernel else 0,
                N_FRAMES if stem_impl == "fused" and deep_base else 0)
    if (launches, stem_launches) != expected:
        raise AssertionError(f"{tag}: K1 / K4 launches {launches} / {stem_launches}, expected "
                             f"{expected[0]} / {expected[1]}")
    return outs, launches, stem_launches


def phase_train_build() -> None:
    from tdnet_tpu_torch.kernels import dropout, propagation_attention_train
    t0 = time.perf_counter()
    propagation_attention_train.build()
    dropout.build()
    log(f"[6] loaded propagation_attention_train.cu and dropout.cu in "
        f"{time.perf_counter() - t0:.2f} s (built in phase 1)")


def _fwd_bwd(fn, q, k, v, dy, **kw):
    """(output, dq, dk, dv) of ``fn`` on leaf copies of q, k, v."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves, **kw)
    out.backward(dy)
    torch.cuda.synchronize()
    return [out.detach()] + [t.grad for t in leaves]


def _train_attention_times(q, k, v, dy, k2, p2) -> dict:
    """(forward ms, backward ms) of the kernel, the plain version and SDPA."""
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    times = {}
    for name, fn, kw in (("kernel", k2, dict(dropout_rate=0.1, seed=SEED)),
                         ("plain", p2, dict(dropout_rate=0.1, seed=SEED)),
                         ("sdpa", None, {})):
        if fn is None:
            fwd = lambda: F.scaled_dot_product_attention(*leaves, scale=1.0 / 8.0)
        else:
            fwd = lambda: fn(*leaves, temperature=8.0, **kw)
        out = fwd()
        bwd = lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)
        times[name] = (median_ms(fwd), median_ms(bwd))
        if name != "plain":   # the kernels each forward and backward runs
            log(f"[7] {name} forward kernels (device ms): {device_kernels(fwd)}")
            log(f"[7] {name} backward kernels (device ms): {device_kernels(bwd)}")
        del out
    return times


def phase_train_attention(card: str) -> dict:
    """K2 against its plain version; returns the kernels entries' numbers."""
    from tdnet_tpu_torch.kernels.propagation_attention_train import (
        propagation_attention_train as k2, propagation_attention_train_plain as p2)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    log(f"[7] training attention kernel vs plain ({card}); tolerances: output 1e-5 x "
        f"max|output|, dq/dk/dv atol 2e-4 rtol 1e-3, keep rate 0.9 +- 1e-3; the forward and "
        f"the backward bitwise equal across two runs")
    res = dict(fwd_err=0.0, bwd_err=0.0)
    hop_ms = {}
    for lq, lkv in TRAIN_SHAPES:
        q, k = (torch.randn(1, n, D_K, generator=gen).to(dev) for n in (lq, lkv))
        v = torch.randn(1, lkv, D_V, generator=gen).to(dev)
        dy = torch.randn(1, lq, D_V, generator=gen).to(dev)
        for rate in (0.0, 0.1):
            kw = dict(temperature=8.0, dropout_rate=rate, seed=SEED + 17)
            got, want = _fwd_bwd(k2, q, k, v, dy, **kw), _fwd_bwd(p2, q, k, v, dy, **kw)
            f_err = (got[0] - want[0]).abs().max().item()
            f_tol = 1e-5 * want[0].abs().max().item()
            g_err = max((a - b).abs().max().item() for a, b in zip(got[1:], want[1:]))
            ok = f_err <= f_tol and all(torch.allclose(a, b, atol=2e-4, rtol=1e-3)
                                        for a, b in zip(got[1:], want[1:]))
            again = _fwd_bwd(k2, q, k, v, dy, **kw)
            same = [torch.equal(got[0], again[0]),
                    all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))]
            with torch.no_grad():
                o64 = p2(q.double(), k.double(), v.double(), **kw)
            rms = lambda o: ((o.double() - o64).pow(2).mean().sqrt()
                             / o64.pow(2).mean().sqrt()).item()
            d_kernel, d_plain = rms(got[0]), rms(want[0])
            log(f"[7] {lq:6d} x {lkv:5d} dropout {rate}: output max abs err {f_err:.3e} "
                f"(tol {f_tol:.3e}), dq/dk/dv max abs err {g_err:.3e}; second forward / "
                f"backward {' / '.join('bitwise equal' if x else 'DIFFERENT' for x in same)}; "
                f"forward's rms distance from float64 over its rms: kernel {d_kernel:.3e}, "
                f"plain {d_plain:.3e}")
            if not ok:
                raise AssertionError(f"K2 disagrees with its plain version at {lq}x{lkv} "
                                     f"dropout {rate}")
            if not all(same):
                raise AssertionError(f"K2 is not deterministic at {lq}x{lkv} dropout {rate}: "
                                     f"forward / backward repeat {same}")
            del o64
            res["fwd_err"] = max(res["fwd_err"], f_err)
            res["bwd_err"] = max(res["bwd_err"], g_err)
            del got, want, again
        # keep rate: uniform scores (q = 0) and v of ones make o_i = kept_i / (0.9 Lkv)
        ones = torch.ones(1, lkv, 128, device=dev)
        o = k2(torch.zeros_like(q), k, ones, temperature=8.0, dropout_rate=0.1, seed=SEED + 17)
        kept = torch.round(o[..., 0].double() * 0.9 * lkv).sum().item()
        rate = kept / (lq * lkv)
        log(f"[7] {lq:6d} x {lkv:5d} observed keep rate {rate:.6f} over {lq * lkv} elements")
        if abs(rate - 0.9) > 1e-3:
            raise AssertionError(f"K2 keep rate {rate} outside 0.9 +- 1e-3")
        del o, ones

        times = _train_attention_times(q, k, v, dy, k2, p2)
        log(f"[7] {lq} x {lkv} forward / backward ms: kernel {times['kernel'][0]:.3f} / "
            f"{times['kernel'][1]:.3f}, plain {times['plain'][0]:.3f} / "
            f"{times['plain'][1]:.3f}, F.scaled_dot_product_attention (no dropout) "
            f"{times['sdpa'][0]:.3f} / {times['sdpa'][1]:.3f}")
        io = 4 * (lq * (D_K + D_V) + lkv * (D_K + D_V))   # q, k, v and o or dy, f32
        fwd_bs = attention_bounds(1, lq, lkv, False, io)
        fwd_b = fwd_bs["tf32x3"]   # the card's rate for f32-accurate products
        bwd_flops, bwd_bytes = 2 * lq * lkv * (2 * D_V + 3 * D_K), 2 * io + 4 * 2 * lq
        bwd_b = bound(bwd_flops, bwd_bytes, PEAK_TF32X3)
        bwd_b32 = bound(bwd_flops, bwd_bytes, PEAK_F32)
        log(f"[7] {lq} x {lkv} bounds: forward {fwd_bs['flops'] / 1e9:.2f} GFLOP: "
            f"{fwd_b['bound_ms']:.3f} ms in 3xTF32 on the tensor cores, "
            f"{fwd_bs['f32']['bound_ms']:.3f} ms in f32 on the CUDA cores; the kernel's "
            f"forward at {fwd_bs['flops'] / times['kernel'][0] / 1e9:.1f} TFLOP/s; backward "
            f"{bwd_flops / 1e9:.2f} GFLOP: "
            f"{bwd_b['bound_ms']:.3f} ms in 3xTF32 on the tensor cores "
            f"({PEAK_TF32X3 / 1e12:.0f} TFLOP/s), {bwd_b32['bound_ms']:.3f} ms in f32 on the "
            f"CUDA cores; the kernel's backward at "
            f"{bwd_flops / times['kernel'][1] / 1e9:.1f} TFLOP/s")
        hop_ms[lq, lkv] = times
        del q, k, v, dy
    log("[7] forward ms, kernel / F.scaled_dot_product_attention: " + "; ".join(
        f"{lq} x {lkv} {t['kernel'][0]:.3f} / {t['sdpa'][0]:.3f}" for (lq, lkv), t in hop_ms.items()))
    # the kernels entries report the last hop, the largest
    return {
        "fwd": dict(max_abs_err=res["fwd_err"], ms=times["kernel"][0],
                    plain_ms=times["plain"][0], library_ms=times["sdpa"][0], **fwd_b),
        "bwd": dict(max_abs_err=res["bwd_err"], ms=times["kernel"][1],
                    plain_ms=times["plain"][1], library_ms=times["sdpa"][1], **bwd_b)}


def phase_dropout(card: str) -> dict:
    """K3 against its plain version; returns the kernels entry's numbers."""
    from tdnet_tpu_torch.cli.profile import kernel_family
    from tdnet_tpu_torch.kernels.dropout import dropout, dropout_plain
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    log(f"[8] dropout kernel vs plain ({card}): bit-identical output and backward, keep rate "
        f"0.9 +- 1e-3")
    for rows in DROP_ROWS:
        x = torch.randn(rows, D_V, generator=gen).to(dev).requires_grad_(True)
        xp = x.detach().clone().requires_grad_(True)
        dy = torch.randn(rows, D_V, generator=gen).to(dev)
        got, want = dropout(x, 0.1, SEED + 5), dropout_plain(xp, 0.1, SEED + 5)
        got.backward(dy)
        want.backward(dy)
        torch.cuda.synchronize()
        keep = (got != 0).double().mean().item()
        same = torch.equal(got.detach(), want.detach())
        same_bwd = torch.equal(x.grad, xp.grad)
        log(f"[8] [{rows}, {D_V}]: output identical {same}, backward identical {same_bwd}, "
            f"keep rate {keep:.6f}")
        if not same_bwd:
            bad = x.grad != xp.grad
            log(f"[8]   {int(bad.sum())} backward elements differ, max abs "
                f"{(x.grad - xp.grad).abs().max().item():.3e}; at kept positions "
                f"{int((bad & (want != 0)).sum())}; kernel backward == kernel forward of dy: "
                f"{torch.equal(x.grad, dropout(dy, 0.1, SEED + 5))}")
        if not (same and same_bwd and abs(keep - 0.9) <= 1e-3):
            raise AssertionError(f"K3 disagrees with its plain version at [{rows}, {D_V}]")
    rows = DROP_ROWS[0]
    x = torch.randn(rows, D_V, generator=gen).to(dev)
    ms = median_ms(lambda: dropout(x, 0.1, SEED))
    plain_ms = median_ms(lambda: dropout_plain(x, 0.1, SEED))
    lib_ms = median_ms(lambda: F.dropout(x, 0.1, training=True))
    b = bound(0, 2 * 4 * rows * D_V, PEAK_F32)
    log(f"[8] [{rows}, {D_V}] ms: kernel {ms:.4f}, plain {plain_ms:.4f}, F.dropout {lib_ms:.4f}; "
        f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}")
    # one trace of both, split by kernel name
    traced = device_rows(lambda: dropout(x, 0.1, SEED), lambda: F.dropout(x, 0.1, training=True))
    device_ms = None
    if traced is not None:
        dev = {"kernel": [r for r in traced if kernel_family(r[0], train=True) == "K3 dropout"]}
        dev["F.dropout"] = [r for r in traced if r not in dev["kernel"]]
        device_ms = sum(t for _, t in dev["kernel"])
        log(f"[8] [{rows}, {D_V}] device ms, one trace: " + "; ".join(
            f"{name} {sum(t for _, t in r):.4f} ({', '.join(f'{k[:60]} {t:.4f}' for k, t in r)})"
            for name, r in dev.items()))
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                device_ms=device_ms, **b)


def plain_train_kernels():
    """The training hops take the plain attention and the plain dropout
    instead of the kernels' wrappers."""
    from tdnet_tpu_torch.kernels import dropout as kd
    from tdnet_tpu_torch.kernels import propagation_attention_train as pat
    from tdnet_tpu_torch.nn import encoding, module
    stack = contextlib.ExitStack()
    stack.enter_context(swapped(encoding, "propagation_attention_train",
                                pat.propagation_attention_train_plain))
    stack.enter_context(swapped(module, "dropout", kd.dropout_plain))
    return stack


def _loss_and_grads(model, loss_of, frames, labels, pos_id, teacher):
    from tdnet_tpu_torch.nn import step_generator
    model.zero_grad(set_to_none=True)
    loss, _ = loss_of(model, frames, labels, pos_id, step_generator(SEED, 0), teacher)
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()
                         if p.grad is not None}


class F64Verdict(NamedTuple):
    """What ``against_f64`` found; ``problem`` is empty where the rule holds."""
    problem: str
    rel: float          # the larger of the two paths' losses' relative distances from float64
    floor: float        # GRAD_FLOOR x the largest max|grad| of the float64 run
    worst: tuple        # (the largest distance / limit, its gradient)
    plain_term: int     # gradients whose limit is mostly twice the plain path's distance
    beyond: int         # gradients of the path beyond GRAD_RTOL x max(max|grad|, floor)
    dists: dict         # gradient -> (the path's and the plain path's distance, its limit)


def against_f64(path, plain, ref) -> F64Verdict:
    """Hold a path's (loss, gradients) to the float64 run ``ref`` beside the
    plain f32 path's: both losses within LOSS_RTOL of float64's, and each
    gradient of the path no farther from float64 than twice the plain path's
    distance plus GRAD_RTOL x max(max|grad|, floor). Two f32 paths that
    round otherwise flip different ReLU inputs that lie within an f32 rounding
    of zero, and at random init one flip moves a gradient by percents of
    max|grad|; float64 tells a path that is as accurate as the plain one from
    a faulty one, which a comparison of the two f32 paths cannot."""
    (loss_k, gk), (loss_p, gp), (loss_d, gd) = path, plain, ref
    rel = max(abs(loss_k - loss_d), abs(loss_p - loss_d)) / abs(loss_d)
    problem = "" if rel <= LOSS_RTOL else f"losses {loss_k} and {loss_p}, float64 {loss_d}"
    if set(gk) != set(gd) or set(gp) != set(gd):
        missing = sorted(set(gd) ^ set(gk) | set(gd) ^ set(gp))
        return F64Verdict(f"gradient sets differ on {missing[:3]}", rel, 0.0, (np.inf, ""), 0,
                          0, {})
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in gd.values())
    worst, plain_term, beyond, dists = (0.0, ""), 0, 0, {}
    for k, g in gd.items():
        scale = max(g.abs().max().item(), floor)
        g = g.to(gk[k].device)
        e_k, e_p = ((x[k].double() - g).abs().max().item() for x in (gk, gp))
        limit = 2 * e_p + GRAD_RTOL * scale
        if not e_k <= limit and not problem:
            problem = (f"gradient {k}: {e_k:.3e} from float64, the plain path {e_p:.3e}, "
                       f"max(max|grad|, floor) {scale:.3e}")
        worst = max(worst, (e_k / limit, k))
        plain_term += 2 * e_p > GRAD_RTOL * scale
        beyond += e_k > GRAD_RTOL * scale
        dists[k] = (e_k, e_p, limit)
    return F64Verdict(problem, rel, floor, worst, plain_term, beyond, dists)


def describe(v: F64Verdict) -> str:
    return (f"worst {v.worst[0]:.3f} of its limit ({v.worst[1]}); the plain term dominates "
            f"{v.plain_term} of {len(v.dists)} limits, {v.beyond} gradients lie beyond "
            f"{GRAD_RTOL:g} x max(max|grad|, floor {v.floor:.2e}); losses' largest rel "
            f"{v.rel:.2e}")


def f64_references(loss_fn, model, start, teacher, frames, labels) -> dict:
    """The float64 run that phases 9 and 14 hold the f32 paths to, dropout
    off and on: the loss and gradients (on the host) from ``start`` at
    ``POS_ID``, the cuDNN path in float64 with K2 and K3 swapped for their
    plain versions (which take float64), the same step generator and so the
    same masks as the f32 paths."""
    from tdnet_tpu_torch.train.trainer import make_loss_of
    model64, teacher64 = copy.deepcopy(model).double(), copy.deepcopy(teacher).double()
    refs = {}
    with plain_train_kernels():
        for use_dropout in (False, True):
            model64.load_state_dict(start)
            loss_of = make_loss_of(loss_fn=loss_fn, use_dropout=use_dropout, conv_wgrad="cudnn")
            loss, grads = _loss_and_grads(model64, loss_of, frames.double(), labels, POS_ID,
                                          teacher64)
            refs[use_dropout] = (loss, {k: g.cpu() for k, g in grads.items()})
    return refs


def kernel_vs_plain(path, plain, noise) -> dict:
    """Phase 9's rule before it also held the paths to float64: the kernel
    path's (loss, gradients) ``path`` against the plain path's, the loss
    within LOSS_RTOL relative and each gradient within GRAD_RTOL x
    max(max|grad|, floor) plus twice the kernel path's run-to-run difference
    ``noise``. Returns the first problem (``problem``, "" for none), the
    largest share of a gradient's limit and how many gradients needed the
    run-to-run term."""
    (loss_k, got), (loss_p, plain) = path, plain
    rel = abs(loss_k - loss_p) / abs(loss_p)
    problem = "" if rel <= LOSS_RTOL else f"loss {loss_k} vs plain {loss_p} (rel {rel:.2e})"
    if set(got) != set(plain):
        differ = f"gradient sets differ on {sorted(set(got) ^ set(plain))[:3]}"
        return dict(problem=problem or differ,
                    worst=(np.inf, ""), needed=0)
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in plain.values())
    worst, needed = (0.0, ""), 0
    for k, g in plain.items():
        scale = g.abs().max().item()
        err = (got[k] - g).abs().max().item()
        tol = GRAD_RTOL * max(scale, floor)
        if not err <= tol + 2 * noise[k] and not problem:
            problem = (f"gradient {k}: kernel vs plain {err:.3e}, max|grad| {scale:.3e}, "
                       f"run-to-run {noise[k]:.3e}")
        needed += err > tol
        worst = max(worst, (err / (tol + 2 * noise[k]), k))
    return dict(problem=problem, worst=worst, needed=needed)


def faulty_forward(eps: float):
    """K2's forward with a relative error ``eps`` on one 64-row q block of
    the last hop (``PROBE_ROWS`` of ``PROBE_LQ``), its backward untouched: a
    fault for phase 9's check to flag."""
    from tdnet_tpu_torch.nn import encoding
    kernel = encoding.propagation_attention_train

    def faulty(q, k, v, **kw):
        o = kernel(q, k, v, **kw)
        if q.shape[1] != PROBE_LQ:
            return o
        err = torch.zeros_like(o)
        err[:, PROBE_ROWS] = eps * o.detach()[:, PROBE_ROWS]
        return o + err

    return swapped(encoding, "propagation_attention_train", faulty)


def check_path(path, plain, ref, noise) -> tuple[str, F64Verdict, dict]:
    """Phase 9's check of a path's (loss, gradients): ``against_f64`` and
    ``kernel_vs_plain`` both. Returns the first problem ("" for none) and the
    two findings."""
    held, old = against_f64(path, plain, ref), kernel_vs_plain(path, plain, noise)
    return held.problem or old["problem"], held, old


def compare_paths(loss_of, model, start, frames, labels, teacher, ref, use_dropout: bool) -> None:
    """The kernel path's loss and gradients against the float64 run ``ref``
    and against the plain path's (K2 and K3 swapped for their plain versions),
    from the state ``start`` and the same step generator (so the same dropout
    masks): ``check_path``. The kernel path also runs with
    ``faulty_forward(PROBE_EPS)``, which the check must flag."""
    model.load_state_dict(start)
    run = lambda: _loss_and_grads(model, loss_of, frames, labels, POS_ID, teacher)
    loss_a, ga = run()
    loss_b, gb = run()
    with faulty_forward(PROBE_EPS):
        probed = run()
    with plain_train_kernels():
        plain = run()
    noise = {k: (ga[k] - gb[k]).abs().max().item() for k in ga}
    problem, held, old = check_path((loss_a, ga), plain, ref, noise)
    setting = f"dropout {'on' if use_dropout else 'off'}, pos_id {POS_ID}"
    repeat = loss_a == loss_b and all(torch.equal(ga[k], gb[k]) for k in ga)
    largest = max(noise, key=noise.get)
    log(f"[9] two identical steps of the kernel path ({setting}): " + (
        "loss and every gradient bitwise equal" if repeat else
        f"DIFFER: losses {loss_a!r} / {loss_b!r}, largest gradient difference "
        f"{noise[largest]:.3e} on {largest}"))
    log(f"[9] kernel path vs float64, beside the plain path ({setting}): loss {loss_a:.6f}, "
        f"plain {plain[0]:.6f}, float64 {ref[0]:.6f}; {describe(held)}")
    nearest = sorted(held.dists.items(), key=lambda kv: -kv[1][0] / kv[1][2])[:5]
    log("[9] nearest their limits (kernel / plain distance from float64, limit): " + "; ".join(
        f"{k} {e_k:.2e} / {e_p:.2e}, {limit:.2e}" for k, (e_k, e_p, limit) in nearest))
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in plain[1].values())
    noisiest = max((2 * noise[k] / g.abs().max().item(), k) for k, g in plain[1].items()
                   if g.abs().max().item() > floor)
    log(f"[9] kernel path vs plain path: worst {old['worst'][0]:.3f} of {GRAD_RTOL:g} x "
        f"max(max|grad|, floor) + 2 x run-to-run ({old['worst'][1]}), {old['needed']} needing "
        f"the run-to-run term; largest 2 x run-to-run / max|grad| above the floor "
        f"{noisiest[0]:.2e} ({noisiest[1]}, limit {NOISE_LIMIT:g})")
    flagged, held_x, old_x = check_path(probed, plain, ref, noise)
    log(f"[9] probe: K2's forward off by {PROBE_EPS:g} on rows {PROBE_ROWS.start}-"
        f"{PROBE_ROWS.stop - 1} of {PROBE_LQ}: {'flagged' if flagged else 'PASSED'}; "
        f"against float64 worst {held_x.worst[0]:.3f} of its limit ({held_x.worst[1]}), "
        f"against the plain path worst {old_x['worst'][0]:.3f} ({old_x['worst'][1]})")
    if problem:
        raise AssertionError(f"[9] kernel path ({setting}): {problem}")
    if noisiest[0] > NOISE_LIMIT:
        raise AssertionError(f"[9] run-to-run difference {noisiest[0]:.2e} x max|grad| on "
                             f"{noisiest[1]} is above {NOISE_LIMIT:g}")
    if not flagged:
        raise AssertionError(f"[9] the check passed K2's forward off by {PROBE_EPS:g} "
                             f"({setting}): it cannot see such a fault")


def phase_train(card: str):
    """The full recipe's train step; returns the recipe (state, its initial
    state dict, teacher, frames, labels, loss_fn, the float64 references) and
    the per-kernel launches of the 8 measured steps."""
    from tdnet_tpu_torch.kernels.dropout import dropout
    from tdnet_tpu_torch.kernels.propagation_attention_train import propagation_attention_train
    from tdnet_tpu_torch.train.trainer import make_loss_of, td4_full_recipe
    state, step, teacher, frames, labels, loss_fn = td4_full_recipe(seed=SEED)
    model, cfg = state.model, state.model.cfg
    # the paths are compared from the seeded initial state: the state after the
    # timed steps carries the noise of cuDNN's nondeterministic weight gradients,
    # so whether some ReLU input sits within an f32 rounding of zero, and flips
    # between the paths, would change from run to run
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    in_size = cfg.in_size
    log(f"[9] TD4-PSP18 full recipe {in_size[0]}x{in_size[1]} b1 f32 ({card}): kv_stride "
        f"{cfg.kv_stride}, aux, OHEM n_min {in_size[0] * in_size[1] // 16}, KD from ResNet-101, "
        f"AdaOptimizer; {sum(p.numel() for p in model.parameters())} student parameters")
    t0 = time.perf_counter()
    m = step(state, frames, labels, 0, teacher)
    torch.cuda.synchronize()
    log(f"[9] warm-up step: loss {m['loss'].item():.5f} kd {m['kd'].item():.5f} "
        f"({time.perf_counter() - t0:.2f} s)")

    counters = ((propagation_attention_train, "launches"),
                (propagation_attention_train, "backward_launches"),
                (dropout, "launches"), (dropout, "backward_launches"))
    for fn, attr in counters:
        setattr(fn, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, frames, labels, i % cfg.path_num, teacher)
        loss = m["loss"].item()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if not np.isfinite(loss) or not np.isfinite(m["kd"].item()):
            raise AssertionError(f"[9] step {i}: loss {loss}, kd {m['kd'].item()}")
    launches = [getattr(fn, attr) for fn, attr in counters]
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"[9] {TRAIN_STEPS} steps, pos_id 0-3: losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"median {float(np.median(times)):.1f} ms/step (min {min(times):.1f}, max "
        f"{max(times):.1f}); peak memory {peak:.0f} MiB; launches K2 fwd/bwd "
        f"{launches[0]}/{launches[1]}, K3 fwd/bwd {launches[2]}/{launches[3]}")
    if launches != [3 * TRAIN_STEPS] * 4:
        raise AssertionError(f"[9] launches {launches}, expected {3 * TRAIN_STEPS} of each")

    t0 = time.perf_counter()
    refs = f64_references(loss_fn, model, start, teacher, frames, labels)
    log(f"[9] float64 run from the initial state, dropout off and on: losses "
        f"{refs[False][0]:.6f} / {refs[True][0]:.6f} ({time.perf_counter() - t0:.1f} s)")
    for use_dropout in (False, True):
        loss_of = make_loss_of(loss_fn=loss_fn, use_dropout=use_dropout)
        compare_paths(loss_of, model, start, frames, labels, teacher, refs[use_dropout],
                      use_dropout)
    return ((state, start, teacher, frames, labels, loss_fn, refs),
            dict(fwd=launches[0], bwd=launches[1], drop=launches[2] + launches[3]))


def phase_stem_kernel(card: str) -> dict:
    """K4 against its plain version; returns the kernels entries' numbers (at
    the TD2 stem shape) per dtype."""
    from tdnet_tpu_torch.cli.profile import kernel_family
    from tdnet_tpu_torch.kernels.fused_stem import fused_stem_plain, fused_stem_tail, stem_tail
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    log(f"[10] fused stem kernel vs plain ({card}); tolerances: f32 1e-4, bf16 2e-2 x max|ref|; "
        f"two calls bitwise equal")
    head = {}
    for h, w in STEM_SHAPES:
        x = torch.randn(1, 64, h, w, generator=gen).relu_().to(dev)
        w1 = (torch.randn(64, 64, 3, 3, generator=gen) * 0.06).to(dev)
        w2 = (torch.randn(128, 64, 3, 3, generator=gen) * 0.06).to(dev)
        sb1, sb2 = (torch.stack([torch.rand(c, generator=gen) + 0.5,
                                 torch.randn(c, generator=gen) * 0.1]).to(dev) for c in (64, 128))
        for dtype, frac in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = (x.to(dtype), w1.to(dtype), sb1, w2.to(dtype), sb2)
            tail = stem_tail(*args[1:])   # laid out once, as a runner does
            got = fused_stem_tail(args[0], tail)
            torch.cuda.synchronize()
            ref = fused_stem_plain(*args)
            err = (got.float() - ref.float()).abs().max().item()
            tol = frac * ref.float().abs().max().item()
            if not (got.shape == ref.shape and np.isfinite(err) and err <= tol):
                raise AssertionError(f"[10] K4 disagrees at {h}x{w} {dtype}: max abs err {err} "
                                     f"> {tol}")
            if not torch.equal(fused_stem_tail(args[0], tail), got):
                raise AssertionError(f"[10] K4 at {h}x{w} {dtype}: two calls differ")
            run = lambda: fused_stem_tail(args[0], tail)
            ms = median_ms(run)
            plain_ms = median_ms(lambda: fused_stem_plain(*args))
            hp, wp = (h + 1) // 2, (w + 1) // 2
            es = got.element_size()
            flops = 2 * h * w * 9 * 64 * (64 + 128)
            nbytes = es * (64 * h * w + 128 * hp * wp + 9 * 64 * (64 + 128)) + 4 * 2 * (64 + 128)
            b32 = bound(flops, nbytes, PEAK_F32)
            # the kernel's route: bf16, or f32 in 3xTF32, on the tensor cores
            b = bound(flops, nbytes, PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32X3)
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            log(f"[10] [1, 64, {h}, {w}] {name:4s} max_abs_err {err:.3e} (tol {tol:.3e}), bitwise "
                f"repeat; kernel {ms:.3f} ms  plain (cuDNN conv sequence) {plain_ms:.3f} ms  "
                f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} on the tensor cores"
                + (f" in 3xTF32, {b32['bound_ms']:.4f} ms on the CUDA cores" if name == "f32"
                   else ""))
            if (h, w) == STEM_SHAPES[0]:
                # one trace of the kernel and the plain sequence, split by name
                both = device_rows(run, lambda: fused_stem_plain(*args))
                device_ms = None
                if both is not None:
                    rows = [r for r in both if kernel_family(r[0]) == "K4 fused stem"]
                    device_ms = sum(t for _, t in rows)
                    log(f"[10] [1, 64, {h}, {w}] {name} device ms, one trace: kernel "
                        f"{device_ms:.4f} ({'; '.join(f'{k[:60]} {t:.4f}' for k, t in rows)}); "
                        f"plain {sum(t for r in both if r not in rows for t in r[1:]):.4f}")
                head[name] = dict(max_abs_err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                                  library_ms=None, **b)
            del got, ref, args, tail
    return head


def phase_psp101(card: str) -> dict:
    """PSP-101 over the 12 frames, fused stem against plain stem, f32 and
    bf16; returns the fused runs' K4 launches per dtype."""
    from tdnet_tpu_torch.models import STREAM_SIZE, PSPNet, PSPNetConfig, init_pspnet
    from tdnet_tpu_torch.stream.runtime import FrameRunner
    cfg = PSPNetConfig(backbone="resnet101", in_size=STREAM_SIZE["psp101"])
    state = init_pspnet(cfg, torch.Generator().manual_seed(SEED)).state_dict()

    def make(dtype, stem_impl):
        net = PSPNet(cfg, "cuda")
        net.load_state_dict(state)
        return FrameRunner(net, dtype=dtype, stem_impl=stem_impl)

    runs = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        frames = stream_frames(cfg.in_size, dtype)
        for stem_impl in ("fused", "plain"):
            run = drive(lambda: make(dtype, stem_impl), frames, card, "12", "psp101")
            want = (0, N_FRAMES if stem_impl == "fused" else 0)
            if run[1:] != want:
                raise AssertionError(f"[12] {stem_impl} stem: K1 / K4 launches {run[1:]}, "
                                     f"expected {want}")
            runs[name, stem_impl] = run
        del frames
    check_close("12", runs["f32", "fused"][0], runs["f32", "plain"][0], 1e-3,
                "fused-stem vs plain-stem f32")
    report_bf16_stream("12", runs["bf16", "fused"][0], runs["bf16", "plain"][0],
                      runs["f32", "plain"][0], "fused-stem vs plain-stem bf16")
    return {name: runs[name, "fused"][2] for name in ("f32", "bf16")}


def phase_dilated_conv(card: str) -> dict:
    """K5 against its plain version and cuDNN; returns the kernels entries'
    numbers (at ``K5_HEADLINE``) for the forward and the dgrad."""
    from tdnet_tpu_torch.cli.profile import kernel_family
    from tdnet_tpu_torch.kernels.dilated_conv import conv2d_dil, dgrad_weights, dilated_conv_plain
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 3)
    h, w = K5_GRID
    log(f"[13] dilated conv kernel vs plain and cuDNN ({card}) at {h}x{w}; tolerances: output "
        f"and dx 5e-5, dW 1e-4 x max|ref|; two identical calls bitwise equal")
    errs = dict(fwd=0.0, dgrad=0.0)
    head = {}
    for ci, co, d in K5_SHAPES:
        x = torch.randn(1, ci, h, w, generator=gen).to(dev)
        wt = (torch.randn(co, ci, 3, 3, generator=gen) / (9 * ci) ** 0.5).to(dev)
        dy = torch.randn(1, co, h, w, generator=gen).to(dev)
        xg, wg = x.clone().requires_grad_(True), wt.clone().requires_grad_(True)
        y = conv2d_dil(xg, wg, d, d)
        y.backward(dy)
        torch.cuda.synchronize()
        xc, wc = x.clone().requires_grad_(True), wt.clone().requires_grad_(True)
        yc = F.conv2d(xc, wc, padding=d, dilation=d)
        yc.backward(dy)
        checks = {  # name: (got, want, fraction of max|want|)
            "fwd vs plain": (y, dilated_conv_plain(x, wt, d, d), 5e-5),
            "dgrad vs plain": (xg.grad, dilated_conv_plain(dy, dgrad_weights(wt), d, d), 5e-5),
            "fwd vs cuDNN": (y, yc, 5e-5),
            "dx vs cuDNN": (xg.grad, xc.grad, 5e-5),
            "dW vs cuDNN": (wg.grad, wc.grad, 1e-4)}
        found = {}
        for name, (got, want, frac) in checks.items():
            err = (got.detach() - want.detach()).abs().max().item()
            tol = frac * want.abs().max().item()
            found[name] = f"{err:.2e} (tol {tol:.2e})"
            if not (got.shape == want.shape and err <= tol):
                raise AssertionError(f"[13] K5 {ci}->{co} d{d}: {name} max abs err {err} > {tol}")
            if name.endswith("vs plain"):
                part = name.split()[0]
                errs[part] = max(errs[part], err)
        log(f"[13] {ci}->{co} d{d} max abs err: " + ", ".join(f"{k} {v}" for k, v in found.items()))
        del yc, checks

        x_dg = x.clone().requires_grad_(True)
        y_dg = conv2d_dil(x_dg, wt, d, d)   # only x needs a gradient: the backward is the dgrad
        dgrad = lambda: torch.autograd.grad(y_dg, x_dg, dy, retain_graph=True)[0]
        with torch.no_grad():
            repeats = dict(fwd=torch.equal(conv2d_dil(x, wt, d, d), y.detach()))
        repeats["dgrad"] = torch.equal(dgrad(), xg.grad)
        if not all(repeats.values()):
            raise AssertionError(f"[13] K5 {ci}->{co} d{d}: two calls differ: {repeats}")
        del y
        with torch.no_grad():
            t = dict(fwd=(median_ms(lambda: conv2d_dil(x, wt, d, d)),
                          median_ms(lambda: dilated_conv_plain(x, wt, d, d)),
                          median_ms(lambda: F.conv2d(x, wt, padding=d, dilation=d))))
        t["dgrad"] = (
            median_ms(dgrad),
            median_ms(lambda: dilated_conv_plain(dy, dgrad_weights(wt), d, d)),
            median_ms(lambda: torch.nn.grad.conv2d_input(x.shape, wt, dy, padding=d, dilation=d)))
        flops, nbytes = 2 * h * w * 9 * ci * co, 4 * (ci * h * w + co * h * w + 9 * ci * co)
        b, b32 = bound(flops, nbytes, PEAK_TF32X3), bound(flops, nbytes, PEAK_F32)
        for part in ("fwd", "dgrad"):
            log(f"[13] {ci}->{co} d{d} {part:5s} ms: kernel {t[part][0]:.3f}, plain "
                f"{t[part][1]:.3f}, cuDNN {t[part][2]:.3f}; bound {b['bound_ms']:.3f} ms "
                f"(3xTF32 tensor cores) by {b['bound_by']}, {b32['bound_ms']:.3f} ms (f32 CUDA "
                f"cores); bitwise repeat {repeats[part]}")
        if (ci, co, d) == K5_HEADLINE:
            traces = dict(
                fwd=(lambda: conv2d_dil(x, wt, d, d),
                     lambda: F.conv2d(x, wt, padding=d, dilation=d)),
                dgrad=(dgrad, lambda: torch.nn.grad.conv2d_input(x.shape, wt, dy, padding=d,
                                                                 dilation=d)))
            device = {}
            for part, (kernel_fn, cudnn_fn) in traces.items():
                both = device_rows(kernel_fn, cudnn_fn)   # one trace, split by name
                device[part] = None
                if both is None:
                    continue
                rows = [r for r in both if kernel_family(r[0], train=True) == "K5 dilated conv"]
                rows_c = [r for r in both if r not in rows]
                device[part] = sum(ms for _, ms in rows)
                prep = sum(ms for k, ms in rows if "prep_" in k)
                log(f"[13] {ci}->{co} d{d} {part} device ms: kernel {device[part]:.3f} (prep "
                    f"{prep:.3f}, {prep / max(device[part], 1e-9):.1%}): "
                    f"{'; '.join(f'{k[:70]} {ms:.3f}' for k, ms in rows)}")
                log(f"[13] {ci}->{co} d{d} {part} device ms: cuDNN {sum(ms for _, ms in rows_c):.3f}: "
                    f"{'; '.join(f'{k[:70]} {ms:.3f}' for k, ms in rows_c)}")
            head = {part: dict(ms=t[part][0], device_ms=device[part], plain_ms=t[part][1],
                               library_ms=t[part][2], **b) for part in ("fwd", "dgrad")}
        del y_dg, x_dg
    return {part: dict(max_abs_err=errs[part], **head[part]) for part in ("fwd", "dgrad")}


def phase_train_k5(card: str, state, start, teacher, frames, labels, loss_fn, refs) -> dict:
    """The recipe with the dilated convs through K5; returns the forward and
    dgrad launches of the measured steps."""
    from tdnet_tpu_torch.kernels.dilated_conv import conv2d_dil
    from tdnet_tpu_torch.train.trainer import make_loss_of, make_train_step
    step = make_train_step(loss_fn=loss_fn, conv_wgrad="kernel")
    model, cfg = state.model, state.model.cfg
    t0 = time.perf_counter()
    m = step(state, frames, labels, 0, teacher)
    torch.cuda.synchronize()
    log(f"[14] TD4-PSP18 full recipe, conv_wgrad=kernel ({card}): warm-up step loss "
        f"{m['loss'].item():.5f} ({time.perf_counter() - t0:.2f} s)")
    conv2d_dil.launches = conv2d_dil.backward_launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(K5_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, frames, labels, i % cfg.path_num, teacher)
        loss = m["loss"].item()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if not np.isfinite(loss) or not np.isfinite(m["kd"].item()):
            raise AssertionError(f"[14] step {i}: loss {loss}, kd {m['kd'].item()}")
    launches = dict(fwd=conv2d_dil.launches, dgrad=conv2d_dil.backward_launches)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"[14] {K5_STEPS} steps: losses {', '.join(f'{x:.4f}' for x in losses)}; median "
        f"{float(np.median(times)):.1f} ms/step (min {min(times):.1f}, max {max(times):.1f}); "
        f"peak memory {peak:.0f} MiB; K5 launches fwd/dgrad {launches['fwd']}/{launches['dgrad']}")
    want = 4 * cfg.path_num * K5_STEPS   # 4 dilated convs in each path's layer4
    if launches != dict(fwd=want, dgrad=want):
        raise AssertionError(f"[14] K5 launches {launches}, expected {want} of each")
    for use_dropout in (False, True):
        compare_with_f64(make_loss_of, loss_fn, model, start, teacher, frames, labels,
                         refs[use_dropout], use_dropout)
    return launches


def compare_with_f64(make_loss_of, loss_fn, model, start, teacher, frames, labels, ref,
                     use_dropout: bool) -> None:
    """The K5 path's loss and gradients against phase 9's float64 run ``ref``,
    beside the cuDNN path's, from the state ``start`` (``against_f64``);
    beside them, the distances from float64 of deterministic cuDNN and of
    K5's plain version."""
    from tdnet_tpu_torch.kernels import dilated_conv

    def run(conv_wgrad):
        model.load_state_dict(start)
        loss_of = make_loss_of(loss_fn=loss_fn, use_dropout=use_dropout, conv_wgrad=conv_wgrad)
        return _loss_and_grads(model, loss_of, frames, labels, POS_ID, teacher)

    k5, cudnn = run("kernel"), run("cudnn")
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        _, g_det = run("cudnn")
    plain_k5 = lambda x, w, p, d, counter, flip=False: dilated_conv.dilated_conv_plain(
        x, dilated_conv.dgrad_weights(w) if flip else w, p, d)
    with swapped(dilated_conv, "_forward", plain_k5):
        _, g_plain = run("kernel")
    held = against_f64(k5, cudnn, ref)
    log(f"[14] K5 path vs float64, beside the cuDNN path (dropout "
        f"{'on' if use_dropout else 'off'}, pos_id {POS_ID}): loss {k5[0]:.6f} / {cudnn[0]:.6f} "
        f"/ {ref[0]:.6f}; {describe(held)}")
    if held.problem:
        raise AssertionError(f"[14] K5 path vs float64: {held.problem}")
    farthest = {}
    for name, grads in (("cuDNN", cudnn[1]), ("deterministic cuDNN", g_det),
                        ("plain K5", g_plain)):
        farthest[name] = max(
            ((grads[k].double() - g.to(grads[k].device)).abs().max().item()
             / max(g.abs().max().item(), held.floor), k) for k, g in ref[1].items())
    log("[14] farthest gradient from float64, x max(max|grad|, floor): " + "; ".join(
        f"{name} {e:.2e} ({k})" for name, (e, k) in farthest.items()))


def main() -> int:
    card = phase_toolchain()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k1 = phase_kernel(card)

    from tdnet_tpu_torch.models import STREAM_SIZE
    td4, td2 = STREAM_SIZE["td4-psp18"], STREAM_SIZE["td2-psp50"]
    f32_frames = stream_frames(td4, torch.float32)
    outs32, n32, _ = run_stream("td4-psp18", td4, torch.float32, f32_frames, card, "3")
    with plain_attention():
        plain, _, _ = run_stream("td4-psp18", td4, torch.float32, f32_frames, card, "3-plain",
                                 kernel=False)
    check_close("3", outs32, plain, 1e-3, "kernel-path vs plain-attention f32")
    del plain, f32_frames

    bf16_frames = stream_frames(td4, torch.bfloat16)
    outs16, n16, _ = run_stream("td4-psp18", td4, torch.bfloat16, bf16_frames, card, "4")
    with plain_attention():
        plain, _, _ = run_stream("td4-psp18", td4, torch.bfloat16, bf16_frames, card, "4-plain",
                                 kernel=False)
    check_close("4", outs16, plain, 3e-2, "kernel-path vs plain-attention bf16")
    check_close("4", outs16, outs32, 5e-2, "bf16 vs f32")
    del outs16, outs32, plain, bf16_frames

    td2_frames = stream_frames(td2, torch.bfloat16)
    outs2, n2, _ = run_stream("td2-psp50", td2, torch.bfloat16, td2_frames, card, "5")
    with plain_attention():
        plain, _, _ = run_stream("td2-psp50", td2, torch.bfloat16, td2_frames, card, "5-plain",
                                 kernel=False)
    check_close("5", outs2, plain, 3e-2, "kernel-path vs plain-attention bf16")

    launches = {"f32": n32, "bf16": n16 + n2}
    del plain, td2_frames

    phase_train_build()
    k2 = phase_train_attention(card)
    k3 = phase_dropout(card)
    recipe, train_launches = phase_train(card)

    k4 = phase_stem_kernel(card)
    stem_launches = {"f32": 0, "bf16": 0}
    td2_frames = stream_frames(td2, torch.bfloat16)
    fused2, _, stem_launches["bf16"] = run_stream("td2-psp50", td2, torch.bfloat16, td2_frames,
                                                  card, "11", stem_impl="fused")
    td2_frames = stream_frames(td2, torch.float32)
    fused32, _, stem_launches["f32"] = run_stream("td2-psp50", td2, torch.float32, td2_frames,
                                                  card, "11-f32", stem_impl="fused")
    plain32, _, _ = run_stream("td2-psp50", td2, torch.float32, td2_frames, card,
                               "11-f32-plain")
    check_close("11", fused32, plain32, 1e-3, "fused-stem vs plain-stem f32")
    report_bf16_stream("11", fused2, outs2, plain32, "fused-stem vs plain-stem bf16")
    del fused2, outs2, fused32, plain32, td2_frames
    for name, n in phase_psp101(card).items():
        stem_launches[name] += n
    k5 = phase_dilated_conv(card)
    k5_launches = phase_train_k5(card, *recipe)

    src = "tdnet_tpu_torch/csrc/"
    entries = [{"name": f"propagation_attention_{dt}", "route": "cuda",
                "source": src + "propagation_attention.cu",
                "replaces": "tdnet_tpu/kernels/propagation_attention.py:127",
                "launches": launches[dt], **k1[dt]} for dt in ("f32", "bf16")]
    entries += [
        {"name": "propagation_attention_train_fwd", "route": "cuda",
         "source": src + "propagation_attention_train.cu",
         "replaces": "tdnet_tpu/kernels/propagation_attention_train.py:154",
         "launches": train_launches["fwd"], **k2["fwd"]},
        {"name": "propagation_attention_train_bwd", "route": "cuda",
         "source": src + "propagation_attention_train.cu",
         "replaces": "tdnet_tpu/kernels/propagation_attention_train.py:188",
         "launches": train_launches["bwd"], **k2["bwd"]},
        {"name": "dropout", "route": "cuda", "source": src + "dropout.cu",
         "replaces": "tdnet_tpu/kernels/dropout.py:38",
         "launches": train_launches["drop"], **k3}]
    entries += [{"name": f"fused_stem_{dt}", "route": "cuda", "source": src + "fused_stem.cu",
                 "replaces": "tdnet_tpu/kernels/fused_stem.py:199",
                 "launches": stem_launches[dt], **k4[dt]} for dt in ("f32", "bf16")]
    entries += [{"name": f"dilated_conv_{part}", "route": "cuda",
                 "source": src + "dilated_conv.cu",
                 "replaces": "tdnet_tpu/kernels/dilated_conv.py:87",
                 "launches": k5_launches[part], **k5[part]} for part in ("fwd", "dgrad")]
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
