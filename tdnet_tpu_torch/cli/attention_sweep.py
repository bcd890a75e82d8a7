"""Time K1's bf16 path in every tiling its kernels take, at the streaming hop shapes.

    python -m tdnet_tpu_torch.cli.attention_sweep [--shapes 33153x2145 18721x1225 1225x1225]
    python -m tdnet_tpu_torch.cli.attention_sweep --train [--shapes 2145x2145 18721x2145]

``--train`` times K2's bf16 forward instead (``grid.TrainFwdPlan``: K1's
kernels with the mask, dropout 0.1), at the training hop shapes, in each
tile of ``grid.TRAIN_TILES``, 2-4 stages and the key splits
``train_forward_plan`` picks and none: phase 7b's rule (one bf16 ulp of
max|plain|), the median of 10 CUDA-event calls and the kernels' device ms.

For each hop shape (q rows x keys; batch 1, d_k 64, d_v 512, with the fc, as
the stream calls it) and each tiling (``grid.Bf16Plan``: q rows a block,
d_v columns a consumer warpgroup, keys a chunk, stages of the p v kernel's
ring), on seeded randn inputs made as ``chip_smoke.py`` phase 2 makes them:
the result against the plain version (phase 2's bf16 rule, 3e-2 x max|ref|),
the median of 10 CUDA-event calls and the kernels' device ms from a
``torch.profiler`` trace of 5 calls, in all and by kernel (stats, p v, fc). The tiling that
``grid.attention_bf16_plan`` picks is marked ``*``. Prints a table, then one
JSON object of all rows. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tdnet_tpu_torch.kernels import propagation_attention as pa
from tdnet_tpu_torch.kernels import propagation_attention_train as pat
from tdnet_tpu_torch.kernels.grid import (BF16_TILES, MAX_SMEM_TRAIN_STAGES, TRAIN_TILES,
                                          Bf16Plan, TrainFwdPlan, attention_bf16_plan,
                                          bf16_max_stages, ceil_div, sm_count,
                                          train_forward_plan)

D_K, D_V = 64, 512
SHAPES = ("33153x2145", "18721x1225", "1225x1225")
TRAIN_SHAPES = ("2145x2145", "18721x2145")
STAGES = (2, 3, 4)


def median_ms(fn, reps: int = 10) -> float:
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, calls: int = 5) -> dict[str, float] | None:
    """The device ms of one call, in all and by kernel: every kernel of ``calls``
    traced calls, summed. A trace that records no kernel is taken again, twice
    at most; then None (not measured)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in prof.key_averages() if r.device_type == torch.autograd.DeviceType.CUDA]
        if sum(r.count for r in rows) == 3 * calls:   # stats, p v and fc each call
            break
    else:
        return None
    parts = dict(stats=0.0, pv=0.0, fc=0.0)
    for r in rows:
        part = "fc" if "fc_bf16" in r.key else "stats" if "true>" in r.key else "pv"
        parts[part] += r.self_device_time_total / 1e3 / calls
    return dict(total=sum(parts.values()), **parts)


def sweep_shape(lq: int, lkv: int, seed: int = 0) -> list[dict]:
    rng = np.random.RandomState(seed)
    host = dict(q=rng.randn(1, lq, D_K), k=rng.randn(1, lkv, D_K), v=rng.randn(1, lkv, D_V),
                w=rng.randn(D_V, D_V) * 0.05, b=rng.randn(D_V) * 0.1)
    t = {n: torch.tensor(a, dtype=torch.float32, device="cuda").to(torch.bfloat16)
         for n, a in host.items()}
    ref = pa.propagation_attention_plain(*(t[n].float() for n in "qkv"), temperature=8.0,
                                         fc_w=t["w"].float(), fc_b=t["b"].float())
    tol = 3e-2 * ref.abs().max().item()
    chosen = attention_bf16_plan(1, lq, lkv, D_V, sm_count(torch.cuda.current_device()))
    rows = []
    for tile in BF16_TILES:
        for stages in STAGES:
            if stages > bf16_max_stages(*tile):
                continue
            plan = Bf16Plan(*tile, stages)
            run = lambda: pa.launch_bf16(t["q"], t["k"], t["v"], 8.0, t["w"], t["b"], plan)
            err = (run().float() - ref).abs().max().item()
            row = dict(lq=lq, lkv=lkv, plan=plan._asdict(), chosen=plan == chosen,
                       max_abs_err=err, ok=bool(err <= tol), ms=median_ms(run),
                       device_ms=device_ms(run))
            rows.append(row)
            dev = row["device_ms"]
            dev = "not measured" if dev is None else (
                f"{dev['total']:.4f} (stats {dev['stats']:.4f}, p v {dev['pv']:.4f}, fc "
                f"{dev['fc']:.4f}) ms")
            print(f"{lq:6d} x {lkv:5d}  rows {plan.rows:3d} cols {plan.cols:3d} keys "
                  f"{plan.keys:3d} stages {plan.stages}{' *' if row['chosen'] else '  '}  "
                  f"{row['ms']:.4f} ms, device {dev}, max abs err {err:.3e}"
                  f"{'' if row['ok'] else f' > {tol:.3e}: WRONG'}", flush=True)
    return rows


def sweep_train_shape(lq: int, lkv: int, seed: int = 0) -> list[dict]:
    gen = torch.Generator().manual_seed(seed)
    q, k = (torch.randn(1, m, D_K, generator=gen).to("cuda", torch.bfloat16) for m in (lq, lkv))
    v = torch.randn(1, lkv, D_V, generator=gen).to("cuda", torch.bfloat16)
    ref = pat.propagation_attention_train_plain(q, k, v, temperature=8.0, dropout_rate=0.1,
                                                seed=seed).float()
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().max())).item() - 7)
    chosen = train_forward_plan(1, lq, lkv, D_V, sm_count(torch.cuda.current_device()))
    rows = []
    for cols, keys in TRAIN_TILES:
        for stages in STAGES:
            if stages > MAX_SMEM_TRAIN_STAGES:
                continue
            for split in sorted({(chosen.stat_kper, chosen.pv_kper),
                                 (ceil_div(lkv, 128), ceil_div(lkv, keys))}):
                plan = TrainFwdPlan(cols, keys, stages, *split)
                run = lambda: pat.launch_bf16_forward(q, k, v, 8.0, 0.1, seed, plan)[0]
                err = (run().float() - ref).abs().max().item()
                row = dict(lq=lq, lkv=lkv, plan=plan._asdict(), chosen=plan == chosen,
                           max_abs_err=err, ok=bool(err <= ulp), ms=median_ms(run),
                           device_ms=train_device_ms(run))
                rows.append(row)
                print(f"{lq:6d} x {lkv:5d}  {plan}{' *' if row['chosen'] else '  '}  "
                      f"{row['ms']:.4f} ms, device {row['device_ms']}, max abs err {err:.3e}"
                      f"{'' if row['ok'] else f' > {ulp:.3e}: WRONG'}", flush=True)
    return rows


def train_device_ms(fn, calls: int = 5) -> dict[str, float] | None:
    """The device ms of one call of K2's bf16 forward, in all and by kernel."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in prof.key_averages() if r.device_type == torch.autograd.DeviceType.CUDA
                and r.count % calls == 0]
        if rows:
            parts = {}
            for r in rows:
                part = ("stats" if "true, false>" in r.key else "pv" if "attn_bf16" in r.key
                        else "keep bits" if "keep_bits" in r.key else "sum" if "sum_scaled" in r.key
                        else "other")
                parts[part] = parts.get(part, 0.0) + r.self_device_time_total / 1e3 / calls
            return {"total": round(sum(parts.values()), 4),
                    **{p: round(t, 4) for p, t in parts.items()}}
    return None


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shapes", nargs="+", default=None,
                        help="hop shapes as <q rows>x<keys>")
    parser.add_argument("--train", action="store_true",
                        help="K2's bf16 forward at the training hops instead of K1")
    args = parser.parse_args(argv)
    shapes = args.shapes or list(TRAIN_SHAPES if args.train else SHAPES)
    if not torch.cuda.is_available():
        raise SystemExit("attention_sweep needs a CUDA device")
    print(torch.cuda.get_device_name(0), flush=True)
    rows = []
    for shape in shapes:
        lq, lkv = (int(x) for x in shape.split("x"))
        rows += sweep_train_shape(lq, lkv) if args.train else sweep_shape(lq, lkv)
    print(json.dumps(rows))
    if not all(r["ok"] for r in rows):
        raise SystemExit("a tiling disagrees with the plain version")


if __name__ == "__main__":
    main()
