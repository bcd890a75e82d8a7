"""Where a stream's frame time, or a train step's time, goes on the card, and
how far it spreads.

    python -m tdnet_tpu_torch.cli.profile --model td4-psp18 td2-psp50 psp101 \\
        --dtype bfloat16 --stem_impl fused --out profiles/
    python -m tdnet_tpu_torch.cli.profile --model td4-psp18-train --conv_wgrad kernel \\
        --out profiles/

For each model (``psp101``: the single-frame PSPNet-101 baseline through
``stream.runtime.FrameRunner``), on seeded random weights and seeded
synthetic frames (``stream.runtime.synthetic_frames``) at the model's
streaming size (``models.STREAM_SIZE``), with the stem ``--stem_impl``, after
one pipelined pass over the 48 frames as a warm-up:

1. 7 pipelined runs over the frames (queued back to back, one synchronize at
   the end): frames/s of each run;
2. hard-synced per-frame latency over the same frames, the first 6 excluded:
   mean, min and max;
3. one ``torch.profiler`` trace of a pipelined run: device ms per frame, the
   sum of the self device time of every kernel the trace records over the
   frame count, split by kernel family;
   idle share = 1 - device ms per frame / wall ms per frame, both of the
   traced run (the profiler's own host work makes it an upper bound);
4. ``nvidia-smi`` SM clock, power draw and temperature just after.

``td4-psp18-train`` is the TD4-PSP18 full training recipe at 769x1537, f32
(``train.trainer.td4_full_recipe``, dilated convs ``--conv_wgrad``): after 2
warm-up steps, 8 synchronized
steps (ms/step of each and the peak memory), then one ``torch.profiler``
trace of 4 steps split by kernel family as above, per step, and the device
time of the upsample's backward (its autograd node's kernels, since its
matrix products fall in the GEMM family).

TF32 is off, as in ``chip_smoke.py``. Prints one JSON object per model;
``--out`` also gets the profiler's kernel table, one file per model, and with
``--shapes`` (the trace records input shapes, which adds host time to it) a
second table of the operators by input shape, which says which conv a
kernel row belongs to. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

FRAMES = 48
REPEATS = 7

# (family, name fragments); a kernel goes to the first family one of whose
# fragments its name contains
FAMILIES = (
    ("K4 fused stem", ("stem_tc",)),
    ("K5 dilated conv", ("dil_tc", "prep_input", "prep_weights")),
    ("K2 training attention backward", ("dkdv_tc", "dq_tc", "rowdot_f32")),
    ("K3 dropout", ("dropout_vec4", "dropout_scalar")),
    # in a train step this family is K2's forward: stats_f32, shared with K1, and pv_fma
    ("K1 propagation attention", ("stats_f32", "pv_tc", "fc_tc", "pv_fma",
                                  "stats_bf16", "pv_bf16", "fc_bf16")),
    ("convolutions (cuDNN)", ("conv", "xmma", "cutlass", "cudnn", "gemm",
                              "nchwToNhwc", "nhwcToNchw")),
    ("adaptive pool", ("adaptive_average_pool",)),
    ("resize", ("upsample",)),
    ("layer norm", ("layer_norm",)),
    ("elementwise (BN affine, activations, adds, casts)", ("elementwise",)),
)


def kernel_family(name: str, train: bool = False) -> str:
    """The family of a kernel name. ``sum_parts`` sums the partial outputs of K1's
    f32 key ranges and of K2's backward: a stream runs only the first, a train
    step only the second."""
    if "sum_parts" in name:
        return "K2 training attention backward" if train else "K1 propagation attention"
    for family, fragments in FAMILIES:
        if any(f in name for f in fragments):
            return family
    return "other"


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def device_breakdown(prof, n_frames: int, train: bool = False):
    """(device ms per frame, ms per frame by family, the 12 longest kernels)."""
    kernels = [r for r in prof.key_averages()
               if r.device_type == torch.autograd.DeviceType.CUDA]
    families: dict[str, float] = {}
    for r in kernels:
        fam = kernel_family(r.key, train)
        families[fam] = families.get(fam, 0.0) + r.self_device_time_total / 1e3 / n_frames
    total = sum(families.values())
    top = sorted(kernels, key=lambda r: -r.self_device_time_total)[:12]
    top = [{"kernel": r.key[:90], "ms_per_frame": r.self_device_time_total / 1e3 / n_frames,
            "calls_per_frame": r.count / n_frames} for r in top]
    return total, dict(sorted(families.items(), key=lambda kv: -kv[1])), top


def write_tables(prof, out: str | None, name: str, shapes: bool, rows: int) -> None:
    if not out:
        return
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{name}.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=rows))
    if shapes:
        with open(os.path.join(out, f"{name}_shapes.txt"), "w") as fh:
            fh.write(prof.key_averages(group_by_input_shape=True).table(
                sort_by="device_time_total", row_limit=rows))


def profile_model(arch: str, dtype, stem_impl: str, out: str | None, shapes: bool) -> dict:
    from tdnet_tpu_torch.models import (STREAM_SIZE, PSPNetConfig, init_pspnet, init_tdnet,
                                        tdnet_config)
    from tdnet_tpu_torch.stream.runtime import (FrameRunner, LatencyMeter, Streamer,
                                                synthetic_frames)
    gen = torch.Generator().manual_seed(0)
    if arch == "psp101":
        cfg = PSPNetConfig(backbone="resnet101", in_size=STREAM_SIZE[arch])
        streamer = FrameRunner(init_pspnet(cfg, gen).to("cuda"), dtype=dtype,
                               stem_impl=stem_impl)
    else:
        cfg = tdnet_config(arch, in_size=STREAM_SIZE[arch])
        streamer = Streamer(init_tdnet(cfg, gen).to("cuda"), dtype=dtype, stem_impl=stem_impl)
    frames = synthetic_frames(FRAMES, cfg.in_size, seed=0, device="cuda", dtype=dtype)
    streamer.run_pipelined(frames)
    fps = [1.0 / streamer.run_pipelined(frames)[1] for _ in range(REPEATS)]
    streamer.meter = LatencyMeter()
    for f in frames:
        streamer.step(f)
    lat = np.asarray(streamer.meter.times) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=shapes) as prof:
        traced_ms = streamer.run_pipelined(frames)[1] * 1e3
    after = smi("clocks.sm,power.draw,temperature.gpu")
    device_ms, families, top = device_breakdown(prof, FRAMES)
    write_tables(prof, out, f"profile_{arch}_{str(dtype)[6:]}_{stem_impl}", shapes, 60)
    return {"model": arch, "dtype": str(dtype)[6:], "stem_impl": stem_impl,
            "in_size": list(cfg.in_size),
            "frames": FRAMES, "frames_per_s": fps,
            "latency_ms": {"mean": float(lat.mean()), "min": float(lat.min()),
                           "max": float(lat.max())},
            "traced_wall_ms_per_frame": traced_ms, "device_ms_per_frame": device_ms,
            "idle_share": 1.0 - device_ms / traced_ms, "families_ms_per_frame": families,
            "top_kernels": top, "smi_after_sm_clock_power_temp": after}


def profile_train(conv_wgrad: str, out: str | None, shapes: bool, steps: int = 8,
                  traced: int = 4) -> dict:
    from tdnet_tpu_torch.train.trainer import td4_full_recipe
    state, step, teacher, frames, labels, _ = td4_full_recipe(conv_wgrad=conv_wgrad)
    p_num = state.model.cfg.path_num
    for i in range(2):
        step(state, frames, labels, i % p_num, teacher)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, frames, labels, i % p_num, teacher)["loss"].item()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**20
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=shapes) as prof:
        t0 = time.perf_counter()
        for i in range(traced):
            step(state, frames, labels, i % p_num, teacher)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / traced
    after = smi("clocks.sm,power.draw,temperature.gpu")
    device_ms, families, top = device_breakdown(prof, traced, train=True)
    # the upsample's backward by its autograd node (ops/resize.py's matrix products)
    resize_bwd = sum(e.device_time_total for e in prof.events()
                     if "evaluate_function:" in e.name and "_ResizeBilinearBackward" in e.name)
    write_tables(prof, out, f"profile_td4-psp18-train_float32_{conv_wgrad}", shapes, 80)
    return {"model": "td4-psp18-train", "dtype": "float32", "conv_wgrad": conv_wgrad,
            "in_size": [769, 1537],
            "ms_per_step": times, "peak_mib": peak, "traced_wall_ms_per_step": traced_ms,
            "device_ms_per_step": device_ms, "idle_share": 1.0 - device_ms / traced_ms,
            "families_ms_per_step": families,
            "resize_backward_device_ms_per_step": resize_bwd / 1e3 / traced,
            "top_kernels_per_step": top,
            "smi_after_sm_clock_power_temp": after}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", nargs="+", default=["td4-psp18", "td2-psp50"],
                        choices=["td4-psp18", "td2-psp50", "psp101", "td4-psp18-train"])
    parser.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    parser.add_argument("--stem_impl", default="plain", choices=["plain", "fused"],
                        help="the streams' stem: 'fused' runs deep-base stems through K4")
    parser.add_argument("--conv_wgrad", default="cudnn", choices=["cudnn", "kernel"],
                        help="the train step's dilated convs: 'kernel' runs them through K5")
    parser.add_argument("--out", default=None, help="directory for the kernel tables")
    parser.add_argument("--shapes", action="store_true",
                        help="record input shapes; --out also gets the table by input shape")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tdnet_tpu_torch.cli.profile needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    print(smi("name,power.limit"), flush=True)
    for arch in args.model:
        res = profile_train(args.conv_wgrad, args.out, args.shapes) \
            if arch == "td4-psp18-train" else \
            profile_model(arch, dtype, args.stem_impl, args.out, args.shapes)
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
